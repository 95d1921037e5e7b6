"""The port's CUDA kernels on the card (tests marked ``cuda``; they skip
without a CUDA device).

This file imports no JAX, so it also runs on a GPU host without JAX:
``python3 -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_cuda.py``.
"""
import ctypes
import dataclasses
import json
import pathlib

import pytest
import torch

import numpy as np

import small_fem_solver_tpu_torch as pt
from small_fem_solver_tpu_torch.ops import hopper_kernels as hk
from small_fem_solver_tpu_torch.ops.condense import (
    ChainFactor, chain_sweep_plain, condense_loads, condense_loads_nested)
from small_fem_solver_tpu_torch.ops.morison import (
    morison_end_forces_batch, morison_phase_batch,
    morison_pointwise_end_forces)

FIELDS = ("nodal_forces", "total_drag", "total_inertia", "total_morison",
          "F1", "F2")
KERNEL_TOL = 1e-5   # f32 kernel vs f64 plain, relative to the largest value
KERNEL_TOL_F64 = 1e-12  # f64 kernel vs f64 plain (sum order only)
SWEEP_TOL_F64 = 1e-12   # f64 sweep kernel vs f64 plain (sum order only)
STORM = dict(wave_dir_deg=38.0, current_dir_deg=38.0, F_axial_kN=25100.0,
             F_shear_kN=2900.0, custom_sw_tonnes=1100.0, sw_mode="custom")
GOLDEN_DIR = pathlib.Path(__file__).parent / "golden"


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("model,N,stretching,alpha,n_members,S,scalars", [
    ("fenton", 12, "none", None, None, 24, "numbers"),
    ("fenton", 12, "wheeler", None, 13, 37, "numbers"),
    ("airy", 1, "none", 1.0 / 7.0, 29, 24, "tensors"),
    ("fenton", 18, "none", None, 201, 129, "tensors"),
    ("airy", 26, "wheeler", 1.0 / 7.0, 37, 37, "numbers"),
])
def test_kernel_matches_plain_f64(model, N, stretching, alpha, n_members, S,
                                  scalars):
    """The f32 kernel against the plain version in f64 on the same
    (f32-rounded) inputs, with per-member Cd: phase counts off the kernel's
    128-phase tile, member counts off its 4-member tile, 1 to 26 modes
    (airy zero-padded to 26), and the scalars as numbers or as 0-d tensors
    on the card (as the scan passes them)."""
    dev = _device()
    refined = pt.refine_model(pt.default_3leg_jacket(dtype=torch.float32,
                                                     device=dev), 4)
    M = n_members or refined.n_members
    wave = pt.make_wave(12.0, 9.4, 50.0, U_c=1.2, model=model, N=N,
                        n_modes=N if model == "airy" else None,
                        dtype=torch.float32, device=dev)
    gen = torch.Generator(device="cpu").manual_seed(0)
    Cd = (0.6 + 0.5 * torch.rand(M, generator=gen)).to(dev)
    D = refined.sections.D_outer[refined.sect_id][:M] / 1000.0
    ts = torch.arange(S, dtype=torch.float32, device=dev) * wave.T / S

    def args(dtype):
        nums = (38.0, 120.0, Cd.to(dtype), 2.0, 1025.0)
        if scalars == "tensors":
            nums = tuple(torch.as_tensor(v, dtype=dtype, device=dev)
                         for v in nums)
        return (wave.to(dtype, dev), refined.coords.to(dtype),
                refined.conn[:M], D.to(dtype), *nums, ts.to(dtype))

    before = hk.morison_phase_batch_cuda.launches
    out = hk.morison_phase_batch_cuda(*args(torch.float32),
                                      current_alpha=alpha,
                                      stretching=stretching)
    torch.cuda.synchronize()
    assert hk.morison_phase_batch_cuda.launches == before + 1
    ref = morison_phase_batch(*args(torch.float64), current_alpha=alpha,
                              stretching=stretching)
    for name in FIELDS:
        assert getattr(out, name).dtype == torch.float32
        assert _rel(getattr(out, name), getattr(ref, name)) < KERNEL_TOL, name


# wave theory, and the heights of one case and of a 3-case batch
FENTON18 = (dict(model="fenton", N=18, n_modes=18), 17.038,
            [9.0, 13.0, 17.038])
STOKES8 = (dict(model="stokes", N=5, n_modes=8), 12.0, [8.0, 12.0, 14.0])
STOKES5 = (dict(model="stokes", N=5, n_modes=5), 12.0, [8.0, 12.0, 14.0])
# make_wave's default (Fenton N = 20): at 3 m-tiles a block (S <= 48) two
# B tiles, at 4 without Wheeler one (the kernel's single-buffered path)
FENTON20 = (dict(model="fenton", N=20, n_modes=20), 17.038,
            [9.0, 13.0, 17.038])
# N >= 27 without Wheeler at 4 m-tiles: one block an SM takes the whole of
# its shared memory; with Wheeler (N >= 25) one B tile
FENTON28 = (dict(model="fenton", N=28, n_modes=28), 17.038,
            [9.0, 13.0, 17.038])
FENTON32 = (dict(model="fenton", N=32, n_modes=32), 17.038,
            [9.0, 13.0, 17.038])


@pytest.mark.cuda
@pytest.mark.parametrize("stretching,alpha,n_members,S,wave", [
    ("none", None, None, 72, FENTON18),
    ("wheeler", 1.0 / 7.0, 37, 37, FENTON18),
    # the dense envelope's tile edge: 36 phases pad to 48, 8 modes
    ("none", None, None, 36, STOKES8),
    ("wheeler", None, 51, 36, STOKES8),
    # an odd mode count: the k-loop pads one mode
    ("wheeler", 1.0 / 7.0, 29, 37, STOKES5),
    ("none", None, None, 50, STOKES5),
    ("none", 1.0 / 7.0, None, 40, FENTON20),
    ("wheeler", None, 37, 40, FENTON20),
    ("none", None, None, 64, FENTON20),
    # the flagship's and the transient's phase counts at the most modes
    ("none", None, None, 360, FENTON28),
    ("none", 1.0 / 7.0, None, 1536, FENTON28),
    ("none", 1.0 / 7.0, None, 360, FENTON32),
    ("none", None, None, 1536, FENTON32),
    ("wheeler", None, 37, 360, FENTON32),
])
def test_f64_kernel_matches_plain_f64(stretching, alpha, n_members, S,
                                      wave):
    """The kernel's float64 (case-batched) instance against the plain
    version in f64 on the same inputs, with per-member Cd / Cm: 1e-12 of
    the largest value, launched once and counted as f64; bit-repeatable.
    Then a batch of 3 cases (per-case waves, phase times, headings, rho,
    per-(case, member) Cd and per-case Cm) in one launch against the
    batched plain version, each case bit-equal to a one-case launch."""
    dev = _device()
    refined = pt.refine_model(pt.default_3leg_jacket(device=dev), 4)
    M = n_members or refined.n_members
    wave_kw, H, Hs = wave
    wave = pt.make_wave(H, 9.4, 50.0, U_c=1.7, device=dev, **wave_kw)
    gen = torch.Generator(device="cpu").manual_seed(1)
    Cd = (0.6 + 0.5 * torch.rand(M, generator=gen, dtype=torch.float64))
    Cm = (1.6 + 0.5 * torch.rand(M, generator=gen, dtype=torch.float64))
    D = refined.sections.D_outer[refined.sect_id][:M] / 1000.0
    ts = torch.arange(S, dtype=torch.float64, device=dev) * wave.T / S
    args = (wave, refined.coords, refined.conn[:M], D, 38.0, 120.0,
            Cd.to(dev), Cm.to(dev), 1025.0, ts)
    before = dict(hk.morison_phase_batch_cuda.instance_launches)
    out = hk.morison_phase_batch_cuda(*args, current_alpha=alpha,
                                      stretching=stretching)
    again = hk.morison_phase_batch_cuda(*args, current_alpha=alpha,
                                        stretching=stretching)
    torch.cuda.synchronize()
    assert hk.morison_phase_batch_cuda.instance_launches == dict(
        before, f64=before["f64"] + 2)
    ref = morison_phase_batch(*args, current_alpha=alpha,
                              stretching=stretching)
    for name in FIELDS:
        assert getattr(out, name).dtype == torch.float64
        assert _rel(getattr(out, name), getattr(ref, name)) \
            < KERNEL_TOL_F64, name
        assert torch.equal(getattr(out, name), getattr(again, name)), name
    with pytest.raises(TypeError, match="mixed dtypes"):
        hk.morison_phase_batch_cuda(*args[:-1], ts.float())

    # three cases in one launch
    waves = pt.make_wave_batch(Hs, 9.4, 50.0, U_c=1.7, dtype=torch.float64,
                               device=dev, **wave_kw)
    f64 = dict(dtype=torch.float64, device=dev)
    tsb = (torch.arange(S, **f64)[None, :] * waves.T[:, None] / S
           + torch.tensor([[0.0], [0.13], [0.41]], **f64))
    Cdb = 0.6 + 0.5 * torch.rand(3, M, generator=gen, dtype=torch.float64)
    Cmb = 1.6 + 0.5 * torch.rand(3, 1, generator=gen, dtype=torch.float64)
    per_case = (torch.tensor([38.0, 100.0, 250.0], **f64),
                torch.tensor([120.0, 38.0, 300.0], **f64), Cdb.to(dev),
                Cmb.to(dev), torch.tensor([1025.0, 1020.0, 1030.0], **f64))
    bargs = (waves, refined.coords, refined.conn[:M], D, *per_case, tsb)
    kw = dict(current_alpha=alpha, stretching=stretching)
    before = hk.morison_phase_batch_cuda.instance_launches["f64"]
    outb = hk.morison_end_forces_batch_cuda(*bargs, **kw)
    torch.cuda.synchronize()
    assert hk.morison_phase_batch_cuda.instance_launches["f64"] == before + 1
    refb = morison_end_forces_batch(*bargs, **kw)
    for a, b in zip(outb, refb):
        assert a.shape == b.shape and _rel(a, b) < KERNEL_TOL_F64
    wd, cdir, Cdc, Cmc, rho = per_case
    for i in range(3):
        one = hk.morison_end_forces_cuda(
            waves.case(i), refined.coords, refined.conn[:M], D, wd[i],
            cdir[i], Cdc[i], Cmc[i, 0], rho[i], tsb[i], **kw)
        assert all(torch.equal(a[i], b) for a, b in zip(outb, one)), i


@pytest.mark.cuda
@pytest.mark.parametrize("stretching", ["none", "wheeler"])
def test_f64_tiling_fits_every_mode_count(stretching):
    """The library tiles the case-batched instance for every mode count the
    wrappers take (N = 1..32) at the phase counts of its paths (36, 72,
    360, 1,536): at least one B tile, within a block's shared memory."""
    dev = _device()
    m = pt.default_3leg_jacket(device=dev)
    wave = pt.make_wave(12.0, 9.4, 50.0, U_c=1.7, model="stokes", N=5,
                        n_modes=5, device=dev)
    k = hk.batch_kernel_operands(
        wave._map(lambda t: t[None]), m.coords, m.conn,
        m.sections.D_outer[m.sect_id] / 1000.0, 38.0, 38.0, 0.7, 2.0, 1025.0,
        torch.zeros(1, 1, dtype=torch.float64, device=dev), 15, None)
    for N in range(1, hk.MAX_MODES + 1):
        for S in (36, 72, 360, 1536):
            kn = dict(k, E=torch.zeros(1, N, dtype=torch.float64, device=dev),
                      U=torch.zeros(1, N, dtype=torch.float64, device=dev),
                      ts=torch.zeros(1, S, dtype=torch.float64, device=dev))
            tl = hk.harm64_tiles(kn, stretching == "wheeler")
            assert tl["NB"] >= 1 and 0 < tl["smem_bytes"] <= 232448, (N, S)


@pytest.mark.cuda
def test_f64_batch_chunks_are_bit_equal(monkeypatch):
    """A batch whose records scratch passes HARM64_SCRATCH_BYTES launches in
    chunks of cases, one launch counted each, bit-equal to one launch."""
    dev = _device()
    m = pt.refine_model(pt.default_3leg_jacket(device=dev), 2)
    waves = pt.make_wave_batch([8.0, 10.0, 12.0, 13.0, 14.0], 9.4, 50.0,
                               U_c=1.7, model="stokes", N=5, n_modes=8,
                               dtype=torch.float64, device=dev)
    f64 = dict(dtype=torch.float64, device=dev)
    dirs = torch.tensor([0.0, 38.0, 100.0, 200.0, 300.0], **f64)
    ts = torch.arange(36, **f64)[None, :] * waves.T[:, None] / 36
    args = (waves, m.coords, m.conn, m.sections.D_outer[m.sect_id] / 1000.0,
            dirs, dirs, 0.7, 2.0, 1025.0, ts)
    one = hk.morison_end_forces_batch_cuda(*args, stretching="wheeler")
    k = hk.batch_kernel_operands(*args, n_gauss=15, current_alpha=None)
    per_case = hk.harm64_tiles(k, True)["scratch"] * 8
    monkeypatch.setattr(hk, "HARM64_SCRATCH_BYTES", 2 * per_case)
    before = hk.morison_phase_batch_cuda.instance_launches["f64"]
    chunked = hk.morison_end_forces_batch_cuda(*args, stretching="wheeler")
    torch.cuda.synchronize()
    assert hk.morison_phase_batch_cuda.instance_launches["f64"] == before + 3
    assert all(torch.equal(a, b) for a, b in zip(one, chunked))


@pytest.mark.cuda
@pytest.mark.parametrize("lo,hi", [(3, 7), (4, 8), (7, 8)])
def test_f64_case_slice_mid_batch_is_bit_equal(lo, hi):
    """K1's case-batched f64 instance on a block of cases that starts
    mid-batch (a rank's block of a case-sharded dense envelope): the
    sliced batch's launch, and the launch of ``case_slice`` operands, give
    the same cases of the whole batch's launch bit for bit, and the block
    matches the plain version at 1e-12."""
    dev = _device()
    m = pt.default_3leg_jacket(device=dev)
    C = 8
    waves = pt.make_wave_batch(np.linspace(4.0, 15.0, C), 9.4, 50.0, U_c=1.7,
                               model="stokes", N=5, n_modes=8,
                               dtype=torch.float64, device=dev)
    f64 = dict(dtype=torch.float64, device=dev)
    dirs = torch.linspace(0.0, 315.0, C, **f64)
    ts = torch.arange(36, **f64)[None, :] * waves.T[:, None] / 36
    D = m.sections.D_outer[m.sect_id] / 1000.0
    args = (waves, m.coords, m.conn, D, dirs, dirs, 0.7, 2.0, 1025.0, ts)
    whole = hk.morison_end_forces_batch_cuda(*args)
    block = hk.morison_end_forces_batch_cuda(
        waves.case(slice(lo, hi)), m.coords, m.conn, D, dirs[lo:hi],
        dirs[lo:hi], 0.7, 2.0, 1025.0, ts[lo:hi])
    assert all(torch.equal(a[lo:hi], b) for a, b in zip(whole, block))
    k = hk.batch_kernel_operands(*args, n_gauss=15, current_alpha=None)
    F1, F2, totals = hk.launch_morison_batch64(hk.case_slice(k, lo, hi),
                                               False)
    assert torch.equal(F1, block[0]) and torch.equal(F2, block[1])
    assert torch.equal(totals[..., :3], block[2])
    plain = morison_end_forces_batch(
        waves.case(slice(lo, hi)), m.coords, m.conn, D, dirs[lo:hi],
        dirs[lo:hi], 0.7, 2.0, 1025.0, ts[lo:hi])
    assert max(_rel(a, b) for a, b in zip(block, plain)) <= KERNEL_TOL_F64


def _batch32_args(dev, C, S, N=8):
    """A C-case f32 batch on the default jacket: Stokes-5 waves of N modes,
    per-case headings, current headings and rho, per-(case, member) Cd,
    per-member Cm; and the same f32-rounded inputs in f64."""
    m = pt.default_3leg_jacket(device=dev)
    waves = pt.make_wave_batch(np.linspace(4.0, 14.0, C), 9.4, 50.0,
                               U_c=1.7, model="stokes", N=5, n_modes=N,
                               dtype=torch.float32, device=dev)
    rng = np.random.default_rng(C * 1000 + S)
    f32 = dict(dtype=torch.float32, device=dev)
    ts = (torch.arange(S, **f32)[None, :] * waves.T[:, None] / S
          + torch.tensor(rng.uniform(0.0, 1.0, (C, 1)), **f32))
    a32 = (waves, m.coords.float(), m.conn,
           (m.sections.D_outer[m.sect_id] / 1000.0).float(),
           torch.tensor(rng.uniform(0.0, 360.0, C), **f32),
           torch.tensor(rng.uniform(0.0, 360.0, C), **f32),
           torch.tensor(rng.uniform(0.6, 1.1, (C, m.n_members)), **f32),
           torch.tensor(rng.uniform(1.6, 2.1, m.n_members), **f32),
           torch.tensor(rng.uniform(1020.0, 1030.0, C), **f32), ts)
    a64 = (waves.to(torch.float64, dev),) + tuple(
        x.double() if x.is_floating_point() else x for x in a32[1:])
    return a32, a64


def _cases(args, lo, hi):
    """Cases lo:hi of a batch's arguments (the per-case ones sliced)."""
    C = args[-1].shape[0]
    return (args[0].case(slice(lo, hi)), *args[1:4],
            *(x[lo:hi] if x.ndim and x.shape[0] == C else x
              for x in args[4:]))


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 7, 1000])
@pytest.mark.parametrize("S", [12, 36, 360])
def test_f32_batch_matches_plain_f64(C, S):
    """K1's case-batched f32 instance against the batched plain version in
    f64 on the same (f32-rounded) inputs, with Wheeler stretching, a
    power-law current, per-(case, member) Cd and per-member Cm: one
    ``f32_batch`` launch for the batch, within 1e-5 of the largest value
    (the plain version runs 25 cases at a time)."""
    dev = _device()
    a32, a64 = _batch32_args(dev, C, S)
    kw = dict(current_alpha=1.0 / 7.0, stretching="wheeler")
    hk.launch_counts(reset=True)
    out = hk.morison_end_forces_batch_cuda(*a32, **kw)
    torch.cuda.synchronize()
    n = hk.launch_counts()
    assert n["f32_batch"] == n["k1"] == 1 and n["f32"] == 0, n
    refs = [morison_end_forces_batch(*_cases(a64, c0, min(C, c0 + 25)),
                                     **kw) for c0 in range(0, C, 25)]
    for a, b in zip(out, (torch.cat(x) for x in zip(*refs))):
        assert a.dtype == torch.float32 and a.shape == b.shape
        assert _rel(a, b) < KERNEL_TOL


@pytest.mark.cuda
def test_f32_batch_cases_are_independent(monkeypatch):
    """A case's F1 / F2 / totals from K1's case-batched f32 instance do not
    depend on the rest of the launch: a mid-batch block of cases, one case
    alone and the ``case_slice`` operands give the whole batch's bits, as
    do two launches of the same batch and a batch launched in chunks."""
    dev = _device()
    a32, _ = _batch32_args(dev, 40, 36)
    kw = dict(stretching="wheeler")
    whole = hk.morison_end_forces_batch_cuda(*a32, **kw)
    again = hk.morison_end_forces_batch_cuda(*a32, **kw)
    assert all(torch.equal(a, b) for a, b in zip(whole, again))
    for lo, hi in ((13, 29), (17, 18), (39, 40)):
        block = hk.morison_end_forces_batch_cuda(*_cases(a32, lo, hi), **kw)
        assert all(torch.equal(a[lo:hi], b) for a, b in zip(whole, block))
    k = hk.batch_kernel_operands(*a32, n_gauss=15, current_alpha=None)
    F1, F2, totals = hk.launch_morison_batch32(hk.case_slice(k, 5, 11), True)
    assert torch.equal(F1, whole[0][5:11]) and torch.equal(F2, whole[1][5:11])
    assert torch.equal(totals[..., 3:], whole[3][5:11])
    rows = hk.f32_batch_tiles(36, 51, 15, 8)["rows"]
    monkeypatch.setattr(hk, "F32_BATCH_PARTIALS_BYTES", 4 * rows * 36 * 6 * 7)
    before = hk.morison_phase_batch_cuda.instance_launches["f32_batch"]
    chunked = hk.morison_end_forces_batch_cuda(*a32, **kw)
    torch.cuda.synchronize()
    assert hk.morison_phase_batch_cuda.instance_launches["f32_batch"] \
        == before + 6
    assert all(torch.equal(a, b) for a, b in zip(whole, chunked))


@pytest.mark.cuda
def test_f32_batch_tiling_matches_the_library():
    """The wrapper-side tile rule of the case-batched f32 instance (the CPU
    emulation's) is the library's, for phase counts within and past one
    tile, member counts around a row's four, and every mode count."""
    dev = _device()
    lib = hk.build("morison_phase_batch")
    a32, _ = _batch32_args(dev, 1, 36)
    k = hk.batch_kernel_operands(*a32, n_gauss=15, current_alpha=None)
    out = (ctypes.c_int * 4)()
    for S in (1, 12, 13, 36, 360, 385, 1536):
        for M in (1, 5, 51, 1632):
            for N in (1, 5, 8, 18, 32):
                for Q in (6, 15):
                    # shared per-member operands: M is the members' count
                    kn = dict(k, conn=k["conn"][:1].expand(M, 2), D=1.0,
                              Cd=0.7, Cm=2.0,
                              E=torch.zeros(1, N, device=dev),
                              U=torch.zeros(1, N, device=dev),
                              ts=torch.zeros(1, S, device=dev),
                              s=k["s"][:Q], w=k["w"][:Q])
                    assert lib.morison_f32_batch_tiles(
                        ctypes.byref(hk._batch_params(kn)), out) == 0
                    t = hk.f32_batch_tiles(S, M, Q, N)
                    assert list(out) == [t["K"], t["n_pt"], t["rows"],
                                         t["bytes"]], (S, M, N, Q)


@pytest.mark.cuda
def test_f32_model_envelope_is_one_batch_launch():
    """``design_envelope`` of an f32 model on the card: one launch of K1's
    case-batched f32 instance for all the cases (no per-case f32 launch),
    its Morison totals within 1e-5 of the f64 model's."""
    dev = _device()
    waves = pt.make_wave_batch(np.linspace(4.0, 14.0, 50), 9.4, 50.0,
                               U_c=1.7, model="stokes", N=5, n_modes=8,
                               dtype=torch.float64, device=dev)
    dirs = np.linspace(0.0, 340.0, 50)
    cases = pt.make_case_batch(pt.LoadCase(**STORM), wave_dir_deg=dirs,
                               current_dir_deg=dirs, t_analysis=np.zeros(50))
    m32 = pt.default_3leg_jacket(dtype=torch.float32, device=dev)
    hk.launch_counts(reset=True)
    env = pt.design_envelope(m32, waves.to(torch.float32, dev), cases,
                             n_steps=36)
    torch.cuda.synchronize()
    n = hk.launch_counts()
    assert n["f32_batch"] == n["k1"] == 1 and n["f32"] == 0, n
    ref = pt.design_envelope(pt.default_3leg_jacket(device=dev), waves,
                             cases, n_steps=36)
    assert _rel(env.total_morison, ref.total_morison) <= KERNEL_TOL
    assert int(env.governing_case) == int(ref.governing_case)


@pytest.mark.cuda
def test_single_rank_nccl_envelope_is_bit_equal(tmp_path):
    """A case-sharded dense envelope in a single-rank NCCL group on the
    card: one K1 f64 launch, bit-equal to the unsharded call."""
    import torch.distributed as dist
    from small_fem_solver_tpu_torch.parallel import multihost as mh
    dev = _device()
    m = pt.default_3leg_jacket(device=dev)
    waves = pt.make_wave_batch([4.0, 9.0, 13.0, 15.0], 9.4, 50.0, U_c=1.7,
                               model="stokes", N=5, n_modes=8,
                               dtype=torch.float64, device=dev)
    cases = pt.make_case_batch(pt.LoadCase(**STORM),
                               wave_dir_deg=[0.0, 38.0, 200.0, 300.0])
    ref = pt.design_envelope(m, waves, cases, n_steps=12)
    assert mh.init_multihost(f"file://{tmp_path}/store", world_size=1,
                             rank=0)
    try:
        before = hk.morison_phase_batch_cuda.instance_launches["f64"]
        env = pt.design_envelope(m, waves, cases, n_steps=12,
                                 mesh=mh.global_case_mesh())
        torch.cuda.synchronize()
        assert hk.morison_phase_batch_cuda.instance_launches["f64"] \
            == before + 1
    finally:
        dist.destroy_process_group()
    assert all(torch.equal(a, b) for a, b in zip(env, ref)
               if a is not None)


@pytest.mark.cuda
def test_kernel_is_bit_repeatable():
    """No float atomics: two launches give identical bits."""
    dev = _device()
    refined = pt.refine_model(pt.default_3leg_jacket(dtype=torch.float32,
                                                     device=dev), 8)
    wave = pt.make_wave(17.038, 9.4, 50.0, U_c=1.7, model="fenton", N=18,
                        dtype=torch.float32, device=dev)
    D = refined.sections.D_outer[refined.sect_id] / 1000.0
    ts = torch.arange(40, dtype=torch.float32, device=dev) * wave.T / 40
    args = (wave, refined.coords, refined.conn, D, 38.0, 38.0, 0.7, 2.0,
            1025.0, ts)
    a = hk.morison_phase_batch_cuda(*args)
    b = hk.morison_phase_batch_cuda(*args)
    for name in ("F1", "F2", "total_drag", "total_inertia"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.cuda
def test_fused_scan_matches_separable_scan():
    """The condensed scan through the kernel (f32 loads and solve) against
    the separable scan in f64 of the same f32-rounded model and wave, at
    n_seg = 4."""
    dev = _device()
    f32, f64 = torch.float32, torch.float64
    case = pt.LoadCase(wave_dir_deg=38.0, current_dir_deg=38.0,
                       F_axial_kN=25100.0, F_shear_kN=2900.0,
                       custom_sw_tonnes=1100.0, sw_mode="custom")
    coarse = pt.default_3leg_jacket(dtype=f32, device=dev)
    refined = pt.refine_model(coarse, 4)
    wave = pt.make_wave(17.038, 9.4, 50.0, U_c=1.7, model="fenton", N=18,
                        dtype=f32, device=dev)
    fused = pt.phase_scan_condensed(coarse, refined, 4, wave, case,
                                    n_steps=16, kinematics="fused",
                                    solve_dtype=f32)

    def as_f64(m):
        return dataclasses.replace(m, coords=m.coords.to(f64),
                                   sections=m.sections.to(f64))
    ref = pt.phase_scan_condensed(as_f64(coarse), as_f64(refined), 4,
                                  wave.to(f64), case, n_steps=16,
                                  kinematics="separable", solve_dtype=f64)
    u32, u64 = fused.utilization.double(), ref.utilization
    assert float((u32 - u64).abs().max() / u64.max()) < 2e-4
    assert _rel(fused.U, ref.U) < 1e-4


def _sweep_factor(dev, solver, level):
    """A real chain factor of the default jacket at n_seg = 32 (f32 solve
    dtype): thomas (n_int 31, 51 chains) or nested level 1 (7, 204) /
    level 2 (3, 51)."""
    coarse = pt.default_3leg_jacket(dtype=torch.float32, device=dev)
    prep = pt.prepare_condensed(coarse, pt.refine_model(coarse, 32), 32,
                                chain_solver=solver,
                                solve_dtype=torch.float32)
    return prep.fac if solver == "thomas" else \
        (prep.fac.fac1, prep.fac.fac2)[level - 1]


def _as(fac, dtype):
    return ChainFactor(*(t.to(dtype).contiguous() for t in fac))


@pytest.mark.cuda
@pytest.mark.parametrize("solver,level", [("thomas", 0), ("nested", 1),
                                          ("nested", 2)])
@pytest.mark.parametrize("B", [1, 5, 18, 37])
def test_chain_sweep_matches_plain_f64(solver, level, B):
    """The sweep kernel in f32 and f64 against the plain sweep in f64 on
    the same (f32-rounded) factors and loads: the narrow form at B = 1, 5,
    18 (one launch counted narrow), the wide form at 37; B * Mc is not a
    multiple of the kernel's block."""
    dev = _device()
    fac = _sweep_factor(dev, solver, level)
    n_int, Mc = fac.Cprime.shape[:2]
    g = torch.tensor(np.random.default_rng(B).normal(size=(B, n_int, Mc, 6))
                     * 1e5, dtype=torch.float32, device=dev)
    ref = chain_sweep_plain(_as(fac, torch.float64), g.double())
    for dtype, tol in ((torch.float32, KERNEL_TOL),
                      (torch.float64, SWEEP_TOL_F64)):
        before = hk.launch_counts()
        out = hk.chain_sweep_cuda(_as(fac, dtype), g.to(dtype))
        torch.cuda.synchronize()
        n = hk.launch_counts()
        assert n["sweep"] == before["sweep"] + 1
        assert n["sweep_narrow"] == before["sweep_narrow"] + (B < 32)
        for a, b in zip(out, ref):
            assert a.dtype == dtype and a.shape == b.shape
            assert _rel(a, b) < tol, (dtype, _rel(a, b))


@pytest.mark.cuda
def test_chain_sweep_is_bit_repeatable():
    dev = _device()
    fac = _sweep_factor(dev, "nested", 1)
    n_int, Mc = fac.Cprime.shape[:2]
    g = torch.randn(40, n_int, Mc, 6, device=dev) * 1e5
    for dtype in (torch.float32, torch.float64):
        a = hk.chain_sweep_cuda(_as(fac, dtype), g.to(dtype))
        b = hk.chain_sweep_cuda(_as(fac, dtype), g.to(dtype))
        for x, y in zip(a, b):
            assert torch.equal(x, y)


@pytest.mark.cuda
def test_fused_envelope_matches_separable_f64():
    """The fused f32 envelope (both kernels) against the separable f64
    envelope of the same f32-rounded model and waves, at n_seg = 4."""
    dev = _device()
    f32, f64 = torch.float32, torch.float64
    coarse = pt.default_3leg_jacket(dtype=f32, device=dev)
    refined = pt.refine_model(coarse, 4)
    waves = pt.make_wave_batch([8.0, 12.5, 17.0], 9.4, 50.0, U_c=1.7,
                               model="fenton", N=12, n_modes=12, dtype=f32,
                               device=dev)
    cases = pt.make_case_batch(pt.LoadCase(**STORM),
                               wave_dir_deg=[0.0, 38.0, 120.0])
    hk.morison_phase_batch_cuda.launches = hk.chain_sweep_cuda.launches = 0
    fused = pt.design_envelope_condensed(coarse, refined, 4, waves, cases,
                                         n_steps=16, kinematics="fused")
    torch.cuda.synchronize()
    assert hk.morison_phase_batch_cuda.launches == 3
    assert hk.chain_sweep_cuda.launches >= 3

    def as_f64(m):
        return dataclasses.replace(m, coords=m.coords.to(f64),
                                   sections=m.sections.to(f64))
    ref = pt.design_envelope_condensed(as_f64(coarse), as_f64(refined), 4,
                                       waves.to(f64), cases, n_steps=16,
                                       solve_dtype=f64,
                                       kinematics="separable")
    assert _rel(fused.max_util_per_case, ref.max_util_per_case) < 1e-4
    assert _rel(fused.member_envelope, ref.member_envelope) < 2e-4
    assert int(fused.governing_case) == int(ref.governing_case)


@pytest.mark.cuda
def test_default_kinematics_give_f64_model_f64_loads():
    """An f64 model's condensed scan and envelope with the default
    kinematics ("fused") launch K1's f64 instance, once a scan and once a
    case, and equal the separable f64 scan and envelope at 1e-12 (f32
    loads would put them ~5e-7 apart); an f32 model's scan still launches
    the f32 instance."""
    dev = _device()
    case = pt.LoadCase(**STORM)
    runs = {}
    for dtype, key, other in ((torch.float64, "f64", "f32"),
                              (torch.float32, "f32", "f64")):
        coarse = pt.default_3leg_jacket(dtype=dtype, device=dev)
        refined = pt.refine_model(coarse, 4)
        wave = pt.make_wave(17.038, 9.4, 50.0, U_c=1.7, model="fenton",
                            N=12, dtype=dtype, device=dev)
        hk.launch_counts(reset=True)
        runs[dtype] = pt.phase_scan_condensed(coarse, refined, 4, wave,
                                              case, n_steps=16,
                                              solve_dtype=dtype)
        torch.cuda.synchronize()
        n = hk.launch_counts()
        assert n[key] == n["k1"] == 1 and n[other] == 0, n
    coarse = pt.default_3leg_jacket(device=dev)
    refined = pt.refine_model(coarse, 4)
    wave = pt.make_wave(17.038, 9.4, 50.0, U_c=1.7, model="fenton", N=12,
                        device=dev)
    sep = pt.phase_scan_condensed(coarse, refined, 4, wave, case, n_steps=16,
                                  kinematics="separable")
    fused = runs[torch.float64]
    for f in ("U", "utilization", "reactions", "total_morison"):
        assert _rel(getattr(fused, f), getattr(sep, f)) <= 1e-12, f

    waves = pt.make_wave_batch([8.0, 12.5, 17.0], 9.4, 50.0, U_c=1.7,
                               model="fenton", N=12, n_modes=12, device=dev)
    cases = pt.make_case_batch(case, wave_dir_deg=[0.0, 38.0, 120.0])

    def envelope(kinematics):
        return pt.design_envelope_condensed(
            coarse, refined, 4, waves, cases, n_steps=16,
            solve_dtype=torch.float64, kinematics=kinematics)
    hk.launch_counts(reset=True)
    env = envelope("fused")
    torch.cuda.synchronize()
    n = hk.launch_counts()
    assert n["f64"] == n["k1"] == 3 and n["f32"] == 0, n
    ref = envelope("separable")
    for f in ("max_util_per_case", "member_envelope", "max_util_per_phase"):
        assert _rel(getattr(env, f), getattr(ref, f)) <= 1e-12, f


@pytest.mark.cuda
def test_chain_sweep_tiling_rule_matches_the_library():
    """The wrapper-side tile and form rules (used by the CPU emulations)
    are the launch's own: the wide form's chains a block by depth, and
    the narrow form's right-hand sides a warp by batch and depth (0: the
    wide form)."""
    _device()
    lib = hk.build("chain_sweep")
    for n_int in (1, 3, 7, 31, 100, 108, 200, 326, 400, 2000):
        for size in (4, 8):
            assert lib.chain_sweep_chains_per_block(n_int, size) == \
                hk.sweep_chains_per_block(n_int, size), (n_int, size)
            for B in (1, 2, 5, 6, 18, 31, 32, 37, 360):
                assert lib.chain_sweep_narrow_rhs(B, n_int, size) == \
                    hk.sweep_narrow_rhs(B, n_int, size), (B, n_int, size)


@pytest.mark.cuda
@pytest.mark.parametrize("solver,level", [("thomas", 0), ("nested", 1)])
def test_chain_sweep_narrow_is_bit_equal_to_wide(solver, level):
    """Column b of a narrow launch is column b of a wide launch on the same
    factors, bit for bit: a batch of B = 40 (wide) against its first 1 and
    18 columns (narrow), in f32 and f64, at the thomas depth 31 and the
    nested level 1."""
    dev = _device()
    fac = _sweep_factor(dev, solver, level)
    n_int, Mc = fac.Cprime.shape[:2]
    g = torch.tensor(np.random.default_rng(40).normal(
        size=(40, n_int, Mc, 6)) * 1e5, dtype=torch.float32, device=dev)
    for dtype in (torch.float32, torch.float64):
        fd, gd = _as(fac, dtype), g.to(dtype)
        assert hk.sweep_narrow_rhs(40, n_int, gd.element_size()) == 0
        wide = hk.chain_sweep_cuda(fd, gd)
        for B in (1, 18):
            before = hk.chain_sweep_cuda.narrow_launches
            narrow = hk.chain_sweep_cuda(fd, gd[:B].contiguous())
            torch.cuda.synchronize()
            assert hk.chain_sweep_cuda.narrow_launches == before + 1
            for a, b in zip(narrow, wide):
                assert torch.equal(a, b[:B]), (dtype, B)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [37, 360])
def test_chain_sweep_strided_layouts(B):
    """The sweep kernel reads g in the caller's layout: the scan's
    transposed chain layout (thomas, levels innermost) and the nested
    level-1 (m, q) view, in f32 and f64, against the plain sweep in f64 on
    a copy; and an untiled depth (n_int = 199, f64: one chain exceeds the
    tile budget) on random factors."""
    dev = _device()
    rng = np.random.default_rng(B)
    fac_t = _sweep_factor(dev, "thomas", 0)
    n_int, Mc = fac_t.Cprime.shape[:2]
    gt = torch.tensor(rng.normal(size=(B, Mc, n_int, 6)) * 1e5,
                      dtype=torch.float32, device=dev).transpose(1, 2)
    coarse = pt.default_3leg_jacket(dtype=torch.float32, device=dev)
    nested = pt.prepare_condensed(coarse, pt.refine_model(coarse, 32), 32,
                                  solve_dtype=torch.float32).fac
    for dtype, tol in ((torch.float32, KERNEL_TOL),
                       (torch.float64, SWEEP_TOL_F64)):
        out = condense_loads(_as(fac_t, dtype), gt.to(dtype))
        ref = chain_sweep_plain(_as(fac_t, torch.float64),
                                gt.double().contiguous())
        for a, b in zip(out, ref):
            assert _rel(a, b) < tol, ("thomas transposed", dtype)
        nested_d = type(nested)(nested.K_super.to(dtype),
                                _as(nested.fac1, dtype),
                                _as(nested.fac2, dtype))
        cpu64 = type(nested)(*(
            ChainFactor(*(t.double().cpu() for t in f))
            if isinstance(f, ChainFactor) else f.double().cpu()
            for f in nested))
        out = condense_loads_nested(nested_d, gt.to(dtype))
        ref = condense_loads_nested(cpu64, gt.double().cpu())
        for a, b in zip((out[0], out[1], *out[2]),
                        (ref[0], ref[1], *ref[2])):
            assert _rel(a, b.to(dev)) < tol, ("nested view", dtype)
    # untiled form: deeper chains than the tile budget holds
    deep = ChainFactor(*(torch.tensor(rng.normal(size=shape) / 6.0,
                                      device=dev)
                         for shape in ((5, 12, 12), (199, 5, 6, 6),
                                       (199, 5, 6, 6), (199, 5, 6, 6),
                                       (199, 5, 6, 6), (199, 5, 6, 6),
                                       (5, 6, 6), (5, 6, 6))))
    assert hk.sweep_chains_per_block(199, 8) == 0
    g = torch.tensor(rng.normal(size=(B, 199, 5, 6)), device=dev)
    for a, b in zip(hk.chain_sweep_cuda(deep, g),
                    chain_sweep_plain(deep, g)):
        assert _rel(a, b) < 1e-10


def _rel_fields(a, b, names):
    return {n: _rel(getattr(a, n).cpu(), getattr(b, n)) for n in names}


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["lu", "chol"])
def test_analyze_on_card_equals_cpu(solver):
    """``analyze`` in f64 on the card (cuSOLVER) against the same call on
    the CPU, and ``analyze_condensed`` (the chain-sweep kernel in f64)
    against its CPU run, every field within 1e-10."""
    dev = _device()
    case = pt.LoadCase(**STORM, t_analysis=0.34)
    fields = ("U", "reactions", "F_applied", "F1_local", "F2_local",
              "von_mises", "utilization", "total_reaction")
    runs = {}
    for d in ("cpu", dev):
        coarse = pt.default_3leg_jacket(device=d)
        wave = pt.make_wave(17.038, 9.4, 50.0, U_c=1.7, model="fenton", N=12,
                            device=d)
        runs[str(d)] = (
            pt.analyze(coarse, wave, case, solver=solver),
            pt.analyze_condensed(coarse, pt.refine_model(coarse, 8), 8,
                                 wave, case, accel="fd"))
    (dense, cond), (dense_c, cond_c) = runs[str(dev)], runs["cpu"]
    assert dense.U.device.type == "cuda"
    errs = {**_rel_fields(dense, dense_c, fields),
            **{f"condensed {k}": v for k, v in
               _rel_fields(cond, cond_c, fields).items()}}
    assert max(errs.values()) <= 1e-10, errs


@pytest.mark.cuda
def test_singular_lstsq_fallback_on_card():
    """The reference's singular golden (an orphan node) on the card: the
    minimum-norm fallback within 1e-6 of the reference's LAPACK gelsd
    answer, the orphan's DOFs exactly 0."""
    dev = _device()
    g = json.loads((GOLDEN_DIR / "singular_case.json").read_text())
    p, geom = g["params"], g["geometry"]
    model = pt.build_model({k: tuple(v) for k, v in geom["nodes"].items()},
                           geom["members"], geom["fixed"], geom["top"],
                           leg_section=(p["D_leg"], p["t_leg"]),
                           brace_section=(p["D_brace"], p["t_brace"]),
                           rho_steel=p["rho_steel"], device=dev)
    wave = pt.airy_wave(p["H"], p["T"], p["d"], p["U_c"], device=dev)
    case = pt.LoadCase(
        E=p["E"], nu=p["nu"], fy=p["fy"], rho_water=p["rho_water"],
        wave_dir_deg=p["wave_dir"], current_dir_deg=p["current_dir"],
        Cd=p["Cd"], Cm=p["Cm"], F_axial_kN=p["F_axial_kN"],
        F_shear_kN=p["F_shear_kN"], M_moment_kNm=p["M_moment_kNm"],
        M_torsion_kNm=p["M_torsion_kNm"],
        custom_sw_tonnes=p.get("custom_sw_tonnes", 0.0),
        t_analysis=p["t_analysis"], sw_mode=p["sw_mode"])
    res = pt.analyze(model, wave, case, solver="lu", lstsq_fallback=True)
    U_ref = torch.tensor(g["fem"]["U"], dtype=torch.float64)
    assert res.U.device.type == "cuda"
    assert _rel(res.U.cpu(), U_ref) <= 1e-6
    orphan = model.node_index("ZZ_ORPHAN")
    assert torch.all(res.U.reshape(-1, 6)[orphan] == 0.0)


# two conductors between leg nodes (as tests/test_torch_options.py)
APPS = [{"name": "C1", "node1": "A2", "node2": "A3", "D_mm": 700.0,
         "cd_mult": 0.8, "cm_mult": 1.1},
        {"name": "RISER-B", "node1": "B1", "node2": "B2", "D_mm": 610.0,
         "cd_mult": 1.05, "cm_mult": 0.95}]
SPRINGS = [1e6, 1e6, 1e6, 1e12, 1e12, 1e12]


def _options_jacket(device, dtype=torch.float64):
    """The default jacket with pinned h-braces and the two conductors."""
    nodes, members, fixed, top = \
        pt.models.presets.default_3leg_jacket_geometry()
    members = [{**m, "release": "pinned" if m["type"] == "h_brace"
                else "none"} for m in members]
    return pt.add_appurtenances(pt.build_model(nodes, members, fixed, top,
                                               dtype=dtype, device=device),
                                APPS)


@pytest.mark.cuda
def test_kernel_per_member_coefficients_with_appurtenances():
    """K1 on the hydrodynamic set of a refined jacket with appurtenances:
    M + A members (off the kernel's member tile) and per-member [M + A]
    Cd/Cm tensors, against the plain version in f64 (1e-5 of max)."""
    from small_fem_solver_tpu_torch.ops.morison import hydro_members
    dev = _device()
    refined = pt.refine_model(_options_jacket(dev, torch.float32), 4)
    conn, D, Cd, Cm = hydro_members(refined, 50.0, 0.7, 2.0)
    assert conn.shape[0] == refined.n_members + 2 and Cd.shape == (
        conn.shape[0],) and float(Cd[-2]) == pytest.approx(0.7 * 0.8)
    wave = pt.make_wave(17.038, 9.4, 50.0, U_c=1.7, model="fenton", N=18,
                        dtype=torch.float32, device=dev)
    ts = torch.arange(37, dtype=torch.float32, device=dev) * wave.T / 37

    def args(dtype):
        return (wave.to(dtype, dev), refined.coords.to(dtype), conn,
                D.to(dtype), 38.0, 120.0, Cd.to(dtype), Cm.to(dtype), 1025.0,
                ts.to(dtype))
    before = hk.morison_phase_batch_cuda.launches
    out = hk.morison_phase_batch_cuda(*args(torch.float32))
    torch.cuda.synchronize()
    assert hk.morison_phase_batch_cuda.launches == before + 1
    ref = morison_phase_batch(*args(torch.float64))
    for name in FIELDS:
        assert _rel(getattr(out, name), getattr(ref, name)) < KERNEL_TOL, name


@pytest.mark.cuda
def test_design_envelope_on_card_matches_cpu():
    """The dense f64 envelope on the card (one launch of the kernel's
    case-batched f64 instance for all the cases) against the same call on
    the CPU (the plain version in f64), with springs, releases and
    appurtenances: the full
    utilization, the Morison totals and the reductions at 1e-10 of their
    maxima, the same governing case."""
    dev = _device()
    runs = {}
    for d in ("cpu", dev):
        waves = pt.make_wave_batch([4.0, 9.0, 13.0], 9.4, 50.0, U_c=1.7,
                                   model="stokes", N=5, n_modes=8,
                                   dtype=torch.float64, device=d)
        cases = pt.make_case_batch(
            pt.LoadCase(**STORM, buoyancy="sealed", wind_speed_ms=30.0),
            wave_dir_deg=[0.0, 38.0, 200.0],
            current_dir_deg=[0.0, 38.0, 200.0])
        hk.morison_phase_batch_cuda.instance_launches["f64"] = 0
        runs[str(d)] = pt.design_envelope(_options_jacket(d), waves, cases,
                                          n_steps=12,
                                          support_stiffness=SPRINGS)
    assert hk.morison_phase_batch_cuda.instance_launches["f64"] == 1
    card, cpu = runs[str(dev)], runs["cpu"]
    assert card.utilization.device.type == "cuda"
    errs = _rel_fields(card, cpu, ("utilization", "total_morison",
                                   "max_util_per_case", "member_envelope"))
    assert max(errs.values()) <= 1e-10, errs
    assert int(card.governing_case) == int(cpu.governing_case)


@pytest.mark.cuda
def test_sprung_phase_scan_on_card_matches_cpu():
    """A separable f64 phase scan on foundation springs with releases,
    appurtenances, buoyancy and wind: the card (cuSOLVER, the f64 sweep
    kernel) against the CPU at 1e-10, and spring reactions -k u."""
    dev = _device()
    case = pt.LoadCase(**STORM, buoyancy="legs-flooded", wind_speed_ms=40.0,
                       wind_dir_deg=38.0, wind_topside_area_m2=800.0)
    runs = {}
    for d in ("cpu", dev):
        coarse = _options_jacket(d)
        wave = pt.make_wave(17.038, 9.4, 50.0, U_c=1.7, model="fenton", N=12,
                            device=d)
        runs[str(d)] = pt.phase_scan_condensed(
            coarse, pt.refine_model(coarse, 4), 4, wave, case, n_steps=8,
            kinematics="separable", support_stiffness=SPRINGS)
    card, cpu = runs[str(dev)], runs["cpu"]
    errs = _rel_fields(card, cpu, ("U", "utilization", "reactions",
                                   "total_morison"))
    assert max(errs.values()) <= 1e-10, errs
    fixed = torch.nonzero(_options_jacket("cpu").fixed_mask).flatten()
    U_sup = cpu.U.reshape(8, -1, 6)[:, fixed]
    assert _rel(cpu.reactions, -torch.tensor(SPRINGS, dtype=torch.float64)
                * U_sup) <= 1e-8


@pytest.mark.cuda
def test_dynamics_on_card_match_cpu():
    """modal_analysis_condensed (4 chain modes: the subspace iteration,
    10 launches of the sweep kernel) and dynamic_response_condensed (all
    18 chain modes; one launch of K1's f64 instance) of the 4x refined
    jacket in f64: the card against the CPU at 1e-10, mode shapes by the
    MAC against the span of their (near-)degenerate CPU cluster."""
    dev = _device()
    runs = {}
    for d in ("cpu", dev):
        coarse = pt.default_3leg_jacket(device=d)
        refined = pt.refine_model(coarse, 4)
        wave = pt.make_wave(17.038, 9.4, 50.0, U_c=1.7, model="fenton", N=18,
                            device=d)
        hk.morison_phase_batch_cuda.instance_launches["f64"] = 0
        hk.chain_sweep_cuda.launches = 0
        runs[str(d)] = (
            pt.modal_analysis_condensed(coarse, refined, 4, n_modes=8,
                                        topside_mass_t=1100.0,
                                        n_chain_modes=4),
            pt.dynamic_response_condensed(coarse, refined, 4, wave,
                                          pt.LoadCase(**STORM),
                                          n_harmonics=4, n_steps=24,
                                          n_chain_modes=18))
    assert hk.morison_phase_batch_cuda.instance_launches["f64"] == 1
    assert hk.chain_sweep_cuda.launches == 10
    (mc, hc), (mp, hp) = runs[str(dev)], runs["cpu"]
    assert _rel(mc.frequencies_hz.cpu(), mp.frequencies_hz) <= 1e-10
    # the sway pair rotates freely inside its plane: each card mode
    # against the span of its CPU cluster
    f, a = mp.frequencies_hz, mc.mode_shapes.cpu()
    for i in range(8):
        Q = torch.linalg.qr(mp.mode_shapes[(f - f[i]).abs()
                                           <= 1e-6 * f[i]].T)[0]
        p = Q.T @ a[i]
        assert float(p @ p / (a[i] @ a[i])) >= 1.0 - 1e-8, i
    errs = _rel_fields(hc, hp, ("U_time", "U_static", "utilization", "daf"))
    assert max(errs.values()) <= 1e-10, errs


@pytest.mark.cuda
@pytest.mark.parametrize("N,S,spreading_s,stretching,alpha,refine,n_gauss", [
    (37, 45, None, "wheeler", None, 4, 15),
    (64, 129, 4.0, "none", 1.0 / 7.0, 4, 15),
    (16, 31, 4.0, "wheeler", None, 4, 15),
    (300, 40, None, "none", None, 4, 15),
    (64, 1023, None, "wheeler", None, 4, 15),
    (37, 515, 4.0, "wheeler", None, 1, 7),
    (37, 131, None, "wheeler", None, 4, 8),
    (16, 67, 4.0, "wheeler", None, 4, 16)])
def test_sea_kernel_matches_plain(N, S, spreading_s, stretching, alpha,
                                  refine, n_gauss):
    """K1's general-mode (random sea) instance with per-member Cd / Cm over
    a half-hour of samples: f32 against the plain version in f64 on the
    same f32-rounded inputs (1e-5 of the largest value; where a Gauss
    point lies within ``hopper_kernels.SURFACE_BAND`` of the surface, over
    the kernel's own outputs off those (sample, member) pairs) and f64
    against f64
    (1e-12).  Mode counts off the 16-mode chunk (and past the harmonic
    instances' 32), sample counts off the 64- and 128-phase tiles, Q = 7
    (two members a tile) on the unrefined jacket, whose 26 member tiles
    are fewer than a grid row, Q = 8 (two members fill a tile) and Q = 16
    (one member fills it, MAX_GAUSS); one launch a call on its instance's
    counter, bit-repeatable."""
    dev = _device()
    refined = pt.default_3leg_jacket(device=dev)
    if refine > 1:
        refined = pt.refine_model(refined, refine)
    M = refined.n_members
    gen = np.random.default_rng(3)
    D = refined.sections.D_outer[refined.sect_id] / 1000.0
    coefs = (torch.tensor(gen.uniform(0.6, 1.1, M), device=dev),
             torch.tensor(gen.uniform(1.6, 2.1, M), device=dev))
    sea = pt.make_random_sea(6.5, 9.4, 50.0, n_components=N, seed=1,
                             U_c=1.0, spreading_s=spreading_s, device=dev)
    ts = torch.linspace(0.0, 1800.0, S, dtype=torch.float64, device=dev)
    kw = dict(n_gauss=n_gauss, current_alpha=alpha, stretching=stretching)
    for dtype, tol in ((torch.float32, KERNEL_TOL),
                       (torch.float64, KERNEL_TOL_F64)):
        ops = hk.cast_operands(dtype, dev, sea, refined.coords, D, 38.0,
                               50.0, *coefs, 1025.0, ts)
        ref_ops = hk.cast_operands(torch.float64, dev, *ops)
        key = "sea_f32" if dtype == torch.float32 else "sea_f64"
        before = hk.morison_phase_batch_cuda.instance_launches[key]
        out = hk.morison_sea_batch_cuda(ops[0], ops[1], refined.conn,
                                        *ops[2:], **kw)
        again = hk.morison_sea_batch_cuda(ops[0], ops[1], refined.conn,
                                          *ops[2:], **kw)
        torch.cuda.synchronize()
        assert hk.morison_phase_batch_cuda.instance_launches[key] \
            == before + 2
        ref = pt.morison_sea_batch(ref_ops[0].to(torch.float64, "cpu"),
                                   ref_ops[1].cpu(), refined.conn.cpu(),
                                   *(o.cpu() if torch.is_tensor(o) else o
                                     for o in ref_ops[2:]), **kw)
        near = (hk.surface_band(ref_ops[0], ref_ops[1], refined.conn,
                                ref_ops[3], ref_ops[-1],
                                n_gauss=n_gauss).cpu()
                if dtype == torch.float32
                else torch.zeros(S, M, dtype=torch.bool))
        assert int(near.sum()) <= 1e-3 * near.numel()
        # held out with a pair: its member's two nodes and its sample's
        # totals
        ends = refined.conn.cpu().T.reshape(-1)
        near_node = torch.zeros(S, refined.n_nodes, dtype=torch.float64)
        near_node.index_add_(1, ends, near.double().repeat(1, 2))
        keep = {"F1": ~near[..., None], "F2": ~near[..., None],
                "nodal_forces": ~(near_node > 0)[..., None]}
        for name in ("total_drag", "total_inertia", "total_morison"):
            keep[name] = ~near.any(dim=1)[:, None]
        for name in FIELDS:
            a, b = getattr(out, name).cpu().double(), getattr(ref, name)
            assert float(((a - b) * keep[name]).abs().max()
                         / b.abs().max()) <= tol, (dtype, name)
        for name in FIELDS:
            assert torch.equal(getattr(out, name), getattr(again, name))
    with pytest.raises(TypeError, match="mixed dtypes"):
        hk.morison_sea_end_forces_cuda(sea.to(torch.float32), refined.coords,
                                       refined.conn, D, 38.0, 50.0, *coefs,
                                       1025.0, ts)


@pytest.mark.cuda
def test_sea_paths_on_card_match_cpu():
    """sea_scan_prepared (one K1-sea f64 launch) and
    spectral_response_prepared on the 4x refined jacket in f64: the card
    against the CPU at 1e-9."""
    dev = _device()
    runs = {}
    for d in ("cpu", dev):
        coarse = pt.default_3leg_jacket(device=d)
        refined = pt.refine_model(coarse, 4)
        prep = pt.prepare_condensed(coarse, refined, 4)
        sea = pt.make_random_sea(6.5, 9.4, 50.0, n_components=24, seed=0,
                                 U_c=1.0, device=d)
        case = pt.LoadCase(**STORM)
        hk.morison_phase_batch_cuda.instance_launches["sea_f64"] = 0
        runs[str(d)] = (
            pt.sea_scan_prepared(prep, sea, case,
                                 torch.arange(256, dtype=torch.float64)
                                 * 0.94,
                                 stretching="wheeler"),
            pt.spectral_response_prepared(prep, sea, case))
    assert hk.morison_phase_batch_cuda.instance_launches["sea_f64"] == 1
    (sc, fc), (sp, fp) = runs[str(dev)], runs["cpu"]
    errs = _rel_fields(sc, sp, ("U", "von_mises", "reactions",
                                "total_morison"))
    # (the MPM stress follows the governing circumferential point, an
    # argmax that roundoff decides between tied opposite points)
    errs.update(_rel_fields(fc, fp, ("sigma_stress", "damage_wl",
                                     "nu0_hz")))
    assert max(errs.values()) <= 1e-9, errs


@pytest.mark.cuda
def test_past_limit_call_launches_no_kernel():
    """A 40-mode f64 dense envelope on the card picks the plain version
    from its shapes (past K1's 32 modes): no K1 launch, one plain route,
    the CPU's result at 1e-12."""
    dev = _device()
    runs = {}
    for d in ("cpu", dev):
        waves = pt.make_wave_batch([4.0, 9.0, 14.0], 9.4, 50.0, U_c=1.7,
                                   model="airy", n_modes=40,
                                   dtype=torch.float64, device=d)
        cases = pt.make_case_batch(pt.LoadCase(**STORM),
                                   wave_dir_deg=[0.0, 38.0, 120.0])
        hk.morison_phase_batch_cuda.launches = 0
        hk.morison_phase_batch_cuda.plain_routes = 0
        runs[str(d)] = pt.design_envelope(
            pt.default_3leg_jacket(device=d), waves, cases, n_steps=8)
        torch.cuda.synchronize()
    assert hk.morison_phase_batch_cuda.launches == 0
    assert hk.morison_phase_batch_cuda.plain_routes == 1
    errs = _rel_fields(runs[str(dev)], runs["cpu"],
                       ("utilization", "max_util_per_case", "total_morison"))
    assert max(errs.values()) <= 1e-12, errs


def _pcg_storm(d, n_seg, precond, **kw):
    model = pt.refine_model(pt.default_3leg_jacket(device=d), n_seg)
    wave = pt.make_wave(9.5, 9.4, 50.0, U_c=1.2, model="stokes", N=5,
                        device=d)
    return pt.analyze(model, wave, pt.LoadCase(**STORM), solver="pcg",
                      accel="analytic", pcg_precond=precond,
                      pcg_maxiter=20000, **kw)


@pytest.mark.cuda
def test_bcsr_matvec_and_pcg_are_bit_repeatable_on_card():
    """The mat-vec's row sums and every CG reduction run in a fixed order
    (no atomics): two runs on the card are bit-equal, with the same
    iteration count, whatever the chunk length."""
    dev = _device()
    from small_fem_solver_tpu_torch.ops import assembly
    from small_fem_solver_tpu_torch.ops.beams import element_stiffness
    m = pt.refine_model(pt.default_3leg_jacket(device=dev), 8)
    Kg = element_stiffness(m.coords, m.conn, m.sections, m.sect_id,
                           210000.0, 210000.0 / 2.6)[0]
    A = assembly.assemble_bcsr(Kg, assembly.build_bcsr_pattern(m.conn,
                                                                m.n_nodes))
    x = torch.randn(m.n_dof, 4, dtype=torch.float64, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))
    assert torch.equal(assembly.bcsr_matvec(A, x),
                       assembly.bcsr_matvec(A, x))
    for precond in ("block_jacobi", "two_level"):
        a, b, c = (_pcg_storm(dev, 8, precond, pcg_chunk=k)
                   for k in (0, 0, 13))
        assert int(a.solver_iters) == int(b.solver_iters) \
            == int(c.solver_iters)
        assert torch.equal(a.U, b.U) and torch.equal(a.U, c.U)


@pytest.mark.cuda
@pytest.mark.parametrize("precond", ["two_level", "block_jacobi"])
def test_pcg_on_card_matches_cpu_9612(precond):
    """The 9,612-DOF flagship mesh at tol 1e-10: iteration counts within
    1% of the port's CPU run, U at 1e-8 and utilization at 1e-7 of it."""
    dev = _device()
    card, cpu = (_pcg_storm(d, 32, precond) for d in (dev, "cpu"))
    assert abs(int(card.solver_iters) - int(cpu.solver_iters)) \
        <= 0.01 * int(cpu.solver_iters)
    assert _rel(card.U.cpu(), cpu.U) <= 1e-8
    assert _rel(card.utilization.cpu(), cpu.utilization) <= 1e-7


# ---- the design tier: soil, seismic, pushover, removal, checks ----

DESIGN_STORM = dict(STORM, t_analysis=0.34)


def _storm(device):
    return (pt.default_3leg_jacket(device=device),
            pt.airy_wave(17.038, 9.4, 50.0, 1.7, device=device),
            pt.LoadCase(**DESIGN_STORM))


@pytest.mark.cuda
def test_batched_factor_matches_single_on_card():
    """``factor_dense`` / ``solve_factored`` of a [B, n, n] stack on the
    card against the single-matrix calls on the card: cuSOLVER's batched
    Cholesky rounds differently from its single-matrix one (on the CPU,
    LAPACK factors each matrix alone and the two are bit-equal,
    ``tests/test_torch_pushover.py``), so factors and solves at 1e-13."""
    dev = _device()
    from small_fem_solver_tpu_torch.ops import solve
    model = pt.default_3leg_jacket(device=dev)
    K = pt.api._dense_system(model, pt.LoadCase().cast(torch.float64,
                                                       dev))[0]
    scale = torch.linspace(0.5, 2.0, 7, dtype=torch.float64,
                           device=dev)[:, None, None]
    Ks = K * scale
    free = solve.free_fixed_dofs(model.fixed_mask)[0]
    F = torch.randn(7, model.n_dof, dtype=torch.float64, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))
    fac = solve.factor_dense(Ks, free)
    U = solve.solve_factored(fac, F)
    for b in range(7):
        single = solve.factor_dense(Ks[b], free)
        assert _rel(fac.chol[b], single.chol) <= 1e-13
        assert _rel(U[b], solve.solve_factored(single, F[b])) <= 1e-13


@pytest.mark.cuda
def test_soil_newton_runs_on_card_and_matches_cpu():
    """The pile's Newton solves run on the card (results there) and give
    the CPU's springs (1e-10) with residuals below 1e-8."""
    dev = _device()
    soil = [pt.SoilLayer("clay", 0.0, 8.0, su_kPa=40.0, gamma_kN_m3=8.0,
                         eps50=0.02),
            pt.SoilLayer("sand", 8.0, 100.0, phi_deg=35.0, gamma_kN_m3=10.0)]
    pile = pt.Pile(D_mm=2134.0, t_mm=50.0, L_m=60.0)
    lat = pt.lateral_solve(pile, soil, 2e6, 3e6, device=dev)
    assert lat.u.is_cuda and float(lat.residual) < 1e-8
    card = pt.pile_head_stiffness(pile, soil, H_kN=2000.0, V_kN=15000.0,
                                  device=dev)
    cpu = pt.pile_head_stiffness(pile, soil, H_kN=2000.0, V_kN=15000.0,
                                 device="cpu")
    assert _rel(torch.tensor(card.support_stiffness),
                torch.tensor(cpu.support_stiffness)) <= 1e-10
    assert (card.residuals < 1e-8).all()


@pytest.mark.cuda
def test_design_tier_on_card_matches_cpu():
    """Response spectrum (CQC), pushover, removal screen and the API member
    check of the storm jacket on the card against the CPU: spectra and
    curves 1e-9, RSR, first yield and flags equal, utilizations 1e-10,
    checks 1e-12."""
    dev = _device()
    (m, w, c), (mc, wc, _) = _storm(dev), _storm("cpu")
    kw = dict(pga_g=0.2, ground="C", topside_mass_t=1100.0)
    a, b = pt.response_spectrum(m, **kw), pt.response_spectrum(mc, **kw)
    for f in ("periods_s", "U_peak", "F1_local", "utilization"):
        assert _rel(getattr(a, f).cpu(), getattr(b, f)) <= 1e-9, f
    push = dict(lambda_max=18.0, n_lambda=7, n_iter=60)
    a, b = pt.pushover(m, w, c, **push), pt.pushover(mc, wc, c, **push)
    assert float(a.rsr) == float(b.rsr)
    assert float(a.first_yield_lambda) == float(b.first_yield_lambda)
    assert torch.equal(a.converged.cpu(), b.converged)
    assert torch.equal(a.n_yielded.cpu(), b.n_yielded)
    assert _rel(a.max_displacement_mm.cpu(), b.max_displacement_mm) <= 1e-9
    a = pt.member_removal_screen(m, w, c)
    b = pt.member_removal_screen(mc, wc, c)
    assert torch.equal(a.critical.cpu(), b.critical)
    assert torch.equal(a.stable.cpu(), b.stable)
    assert _rel(a.max_util.cpu(), b.max_util) <= 1e-10
    ra, rb = pt.analyze(m, w, c), pt.analyze(mc, wc, c)
    a, b = pt.member_code_check(m, ra), pt.member_code_check(mc, rb)
    assert _rel(a.uc.cpu(), b.uc) <= 1e-12
    assert (a.governing == b.governing).all()


@pytest.mark.cuda
def test_design_gradients_on_card_match_cpu():
    """``section_sensitivities`` (the backward of the dense f64 Cholesky on
    the card) and three ``optimize_sections`` steps on the card against
    the CPU: gradients 1e-10, thicknesses and history 1e-8; no launch."""
    dev = _device()

    def inputs(device):
        return (pt.default_3leg_jacket(device=device),
                pt.make_wave(17.038, 9.4, 50.0, U_c=1.7, model="stokes", N=5,
                             device=device),
                pt.LoadCase(**STORM, t_analysis=0.34))
    before = hk.launch_counts()
    a = pt.section_sensitivities(*inputs(dev))
    b = pt.section_sensitivities(*inputs("cpu"))
    assert a.dutil.is_cuda
    for f in ("dutil", "dmass_t", "util_max", "mass_t"):
        assert _rel(getattr(a, f).cpu(), getattr(b, f)) <= 1e-10, f
    a = pt.optimize_sections(*inputs(dev), target_util=0.5, n_iter=3)
    b = pt.optimize_sections(*inputs("cpu"), target_util=0.5, n_iter=3)
    assert _rel(a.t.cpu(), b.t) <= 1e-8
    assert np.abs(a.history / b.history - 1.0).max() <= 1e-8
    assert hk.launch_counts() == before


@pytest.mark.cuda
def test_reliability_batch_is_one_k1_launch():
    """One batch of ``member_utilization_response_batch`` on an f64 model
    on the card is one launch of K1's case-batched f64 instance, and equals
    the CPU's plain run (1e-10)."""
    dev = _device()
    kw = dict(d=50.0, U_c=1.7, wave_model="airy", n_steps=12)
    hs = np.array([6.0, 12.0, 17.0, 24.0, 36.0])
    tp = np.array([9.0, 11.0, 9.4, 12.5, 6.0])
    case = pt.LoadCase(**STORM)
    resp = pt.member_utilization_response_batch(
        pt.default_3leg_jacket(device=dev), case, **kw)
    before = hk.morison_phase_batch_cuda.instance_launches["f64"]
    card = resp(hs, tp)
    assert hk.morison_phase_batch_cuda.instance_launches["f64"] == before + 1
    cpu = pt.member_utilization_response_batch(
        pt.default_3leg_jacket(device="cpu"), case, **kw)(hs, tp)
    assert card.shape == (5, 51)
    assert np.abs(card - cpu).max() / np.abs(cpu).max() <= 1e-10


# ---- the pointwise Morison kernel (csrc/morison_pointwise.cu) ----

# (accel, stretching, current_alpha, per-member Cd, slam_cs); the first is
# the slam scan's
POINTWISE_OPTIONS = [
    ("analytic", "none", None, False, 5.15),
    ("fd", "none", None, False, 0.0),
    ("analytic", "wheeler", 1.0 / 7.0, True, 0.0),
    ("fd", "wheeler", 0.2, False, 5.15),
    ("fd", "none", None, True, float(np.pi)),
]


def _slam_scan_operands(dev, per_member=False):
    """The slam scan's shapes in float32 on the card: the 9,612-DOF mesh's
    1,632 members, a Fenton N 18 storm, 360 phases; scalars as 0-d tensors
    (as the scan passes them), Cd per member or a tensor."""
    f32 = torch.float32
    refined = pt.refine_model(pt.default_3leg_jacket(dtype=f32, device=dev),
                              32)
    wave = pt.make_wave(17.038, 9.4, 50.0, U_c=1.7, model="fenton", N=18,
                        dtype=f32, device=dev)
    M = refined.n_members
    gen = torch.Generator(device="cpu").manual_seed(2)
    Cd = ((0.6 + 0.5 * torch.rand(M, generator=gen)).to(dev) if per_member
          else torch.tensor(0.7, device=dev))
    D = refined.sections.D_outer[refined.sect_id] / 1000.0
    ts = torch.arange(360, dtype=f32, device=dev) * wave.T / 360

    def scalar(v):
        return torch.tensor(v, dtype=f32, device=dev)
    return (wave, refined.coords, refined.conn, D, scalar(38.0),
            scalar(120.0), Cd.to(f32), scalar(2.0), scalar(1025.0), ts)


def _cast_pointwise(args, dtype):
    """``_slam_scan_operands`` in ``dtype`` (``conn`` as it is)."""
    dev = args[1].device
    return (*hk.cast_operands(dtype, dev, *args[:2]), args[2],
            *hk.cast_operands(dtype, dev, *args[3:]))


@pytest.mark.cuda
@pytest.mark.parametrize("accel,stretching,alpha,per_member,slam",
                         POINTWISE_OPTIONS)
def test_pointwise_kernel_matches_plain_f64(accel, stretching, alpha,
                                            per_member, slam):
    """Both instances of the pointwise kernel against the plain version in
    f64 on the same (f32-rounded) operands at the slam scan's shapes (M
    1,632, Q 15, N 18, S 360): f32 at 1e-5 of the largest value off the
    (phase, member) pairs with a point within 1e-4 m of a jump (the
    surface, at t + dt too under fd, the slam band's edges), f64 at 1e-12
    everywhere; one launch a call."""
    dev = _device()
    args = _slam_scan_operands(dev, per_member)
    kw = dict(n_gauss=15, accel=accel, stretching=stretching,
              current_alpha=alpha, slam_cs=slam)
    ref = morison_pointwise_end_forces(*_cast_pointwise(args, torch.float64),
                                       **kw)
    far = ~hk.pointwise_band(args[0], args[1], args[2], args[3], 38.0,
                             args[9], slam=slam > 0, fd=accel == "fd")
    assert far.float().mean() > 0.5
    phases = far.all(dim=1)
    for dtype, tol in ((torch.float32, KERNEL_TOL),
                       (torch.float64, KERNEL_TOL_F64)):
        before = hk.launch_counts()
        out = hk.morison_pointwise_end_forces_cuda(
            *_cast_pointwise(args, dtype), **kw)
        torch.cuda.synchronize()
        n = hk.launch_counts()
        assert n["pointwise"] == before["pointwise"] + 1
        assert n["k1"] == before["k1"]
        for name, a, b in zip(("F1", "F2", "drag", "inertia"), out, ref):
            assert a.dtype == dtype and a.shape == b.shape, name
            if dtype == torch.float32:
                keep = far if a.dim() == 3 else phases
                a, b = a[keep], b[keep]
            assert _rel(a, b) <= tol, (name, dtype, _rel(a, b))


@pytest.mark.cuda
def test_pointwise_kernel_is_bit_repeatable():
    """No float atomics: two launches of either instance give identical
    bits."""
    dev = _device()
    args = _slam_scan_operands(dev)
    for dtype in (torch.float32, torch.float64):
        cast = _cast_pointwise(args, dtype)
        kw = dict(accel="fd", stretching="wheeler", slam_cs=5.15)
        a = hk.morison_pointwise_end_forces_cuda(*cast, **kw)
        b = hk.morison_pointwise_end_forces_cuda(*cast, **kw)
        assert all(torch.equal(x, y) for x, y in zip(a, b)), dtype


@pytest.mark.cuda
def test_pointwise_scan_is_one_pointwise_launch():
    """``phase_scan_prepared(kinematics='pointwise')`` on the card (the
    slam scan's f32 model and options): one pointwise launch, no K1
    launch; at n_seg 4 in f64 the card equals the CPU at 1e-12."""
    dev = _device()
    case = pt.LoadCase(**STORM, slam_cs=5.15)
    f32 = torch.float32
    coarse = pt.default_3leg_jacket(dtype=f32, device=dev)
    prep = pt.prepare_condensed(coarse, pt.refine_model(coarse, 32), 32,
                                solve_dtype=f32)
    wave = pt.make_wave(17.038, 9.4, 50.0, U_c=1.7, model="fenton", N=18,
                        dtype=f32, device=dev)
    hk.launch_counts(reset=True)
    pt.phase_scan_prepared(prep, wave, case, 360, kinematics="pointwise")
    torch.cuda.synchronize()
    n = hk.launch_counts()
    assert (n["pointwise"], n["k1"]) == (1, 0), n
    runs = {}
    for d in ("cpu", dev):
        c = pt.default_3leg_jacket(device=d)
        w = pt.make_wave(17.038, 9.4, 50.0, U_c=1.7, model="fenton", N=12,
                         device=d)
        runs[str(d)] = pt.phase_scan_condensed(
            c, pt.refine_model(c, 4), 4, w, case, n_steps=36,
            kinematics="pointwise", accel="fd", stretching="wheeler")
    errs = _rel_fields(runs[str(dev)], runs["cpu"],
                       ("U", "utilization", "reactions", "total_morison"))
    assert max(errs.values()) <= 1e-12, errs


@pytest.mark.cuda
def test_pointwise_kernel_past_16_points_and_32_modes():
    """The pointwise kernel takes any number of Gauss points (passes of 16
    lanes) and modes (shared memory sized by N): a Fenton N 40 scan with
    17 Gauss points on the card is one pointwise launch and no K1 launch,
    and equals the CPU at 1e-12 (f64); 33 points (three passes) of the
    f64 instance equal the plain version at 1e-12."""
    dev = _device()
    runs = {}
    for d in ("cpu", dev):
        c = pt.default_3leg_jacket(device=d)
        w = pt.make_wave(12.0, 9.4, 50.0, U_c=1.2, model="fenton", N=40,
                         device=d)
        hk.launch_counts(reset=True)
        runs[str(d)] = pt.phase_scan_condensed(
            c, pt.refine_model(c, 4), 4, w,
            pt.LoadCase(**STORM, slam_cs=5.15), n_steps=24, n_gauss=17,
            kinematics="pointwise", accel="fd", stretching="wheeler")
        torch.cuda.synchronize()
        counts = hk.launch_counts()
    assert (counts["pointwise"], counts["k1"]) == (1, 0), counts
    errs = _rel_fields(runs[str(dev)], runs["cpu"],
                       ("U", "utilization", "reactions", "total_morison"))
    assert max(errs.values()) <= 1e-12, errs
    m = pt.refine_model(pt.default_3leg_jacket(device=dev), 4)
    D = m.sections.D_outer[m.sect_id] / 1000.0
    ts = torch.arange(24, dtype=torch.float64, device=dev) * w.T / 24
    args = (w, m.coords, m.conn, D, 38.0, 120.0, 0.7, 2.0, 1025.0, ts)
    kw = dict(n_gauss=33, accel="analytic", slam_cs=5.15)
    out = hk.morison_pointwise_end_forces_cuda(*args, **kw)
    ref = morison_pointwise_end_forces(*args, **kw)
    for name, a, b in zip(("F1", "F2", "drag", "inertia"), out, ref):
        assert _rel(a, b) <= KERNEL_TOL_F64, (name, _rel(a, b))
