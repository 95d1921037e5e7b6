"""PyTorch port vs the JAX package: the sharded paths on
``torch.distributed`` (``mesh=``, ``parallel.multihost``,
``parallel.pcg_dist``).

The port's calls run in gloo ranks on the CPU, started by
``parallel.multihost.spawn_ranks``: one launch of 2 ranks and one of 3,
each running all its calls in one group.  The JAX references run in this
process on ``Mesh(jax.devices()[:k])`` of the conftest's 8 virtual
devices.  Mirrors ``tests/test_envelope.py`` (dense and condensed
envelopes at n_seg 2, 6 cases of Stokes-5, f64: 1e-10 and 1e-12 against
JAX), ``tests/test_parallel.py`` (the sharded sweep, the multi-host
helpers at 2 ranks and on one process), ``tests/test_freqdomain.py`` (the
scatter with 3 states over 2 ranks, quasi-static and dynamic, 1e-12) and
``tests/test_pcg_dist.py`` (``shard_bcsr``, ``distributed_pcg`` against
JAX's and the dense Cholesky, ``analyze(solver="pcg", mesh=)``).  Every
rank returns bit-identical results.

Bit-equal to the port's unsharded call: the condensed envelope (each case
its own solve), the dense envelope (on the CPU a block's multi-RHS solve
and recovery round as the whole batch's), the scatter (each state its own
solve).  Not bit-equal: the sweep, whose batched recovery products round
with the batch size (~1e-15 in reactions and end forces; U is bit-equal),
the multi-host envelopes, whose waves are built per rank block, and the
dynamic scatter, whose Craig-Bampton basis each rank builds on its share
of the host's threads (1e-12).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

import small_fem_solver_tpu as sf
from small_fem_solver_tpu.ops import assembly as ja
from small_fem_solver_tpu.ops.beams import element_stiffness as j_es
from small_fem_solver_tpu.parallel import pcg_dist as jpd
from small_fem_solver_tpu.parallel import sweep as jsweep
import small_fem_solver_tpu_torch as pt
from small_fem_solver_tpu_torch.ops import assembly as ta
from small_fem_solver_tpu_torch.ops import beams as tb
from small_fem_solver_tpu_torch.ops import solve as ts
from small_fem_solver_tpu_torch.parallel import comm
from small_fem_solver_tpu_torch.parallel import multihost as mh
from small_fem_solver_tpu_torch.parallel import pcg_dist as tpd
from test_torch_convert import port_case, port_model, port_wave, rel_err

N_SEG = 2
HS = np.linspace(3.0, 15.0, 6)
BASE = dict(wave_dir_deg=38.0, current_dir_deg=38.0, F_axial_kN=25100.0,
            F_shear_kN=2900.0, custom_sw_tonnes=1100.0, sw_mode="custom")
WAVE_KW = dict(U_c=1.7, model="stokes", N=5, n_modes=8)
STATES = [(4.0, 8.0, 0.2), (6.5, 9.5, 0.1, 60.0), (8.0, 11.0, 0.05)]
SCATTER_KW = dict(exposure_years=25.0, n_components=8)
PCG_SEG = 3             # 123 nodes: 2 ranks pad one node, 3 ranks none
CASES = mh.RankMesh("cases")
DOF = mh.RankMesh("dof")
HEADINGS = mh.RankMesh("headings")
ROSE = [10.0, 130.0, 250.0, 70.0]
ROSE_KW = dict(lambda_max=16.0, n_lambda=3, n_iter=10)
F64 = torch.float64


def same(a, b) -> bool:
    """Bit equality of two result trees (tensors, arrays, tuples)."""
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and a.shape == b.shape and bool(
            torch.equal(a, b) or (torch.isnan(a) == torch.isnan(b)).all()
            and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)))
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b, equal_nan=True)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if dataclasses.is_dataclass(a):
        return all(same(getattr(a, f.name), getattr(b, f.name))
                   for f in dataclasses.fields(a))
    return a == b


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Both packages' default jacket, its 2x refinement, the 6-case
    Stokes-5 batch, the scatter's prepared handle, and the PCG system (the
    3x refinement, a seeded load) in the port."""
    jm = sf.default_3leg_jacket()
    jr = sf.refine_model(jm, N_SEG)
    jw = jsweep.make_wave_batch(HS, 9.4, 50.0, dtype=jnp.float64, **WAVE_KW)
    jc = jsweep.make_case_batch(sf.LoadCase(**BASE),
                                t_analysis=jnp.zeros(len(HS)))
    d = dict(jm=jm, jr=jr, jw=jw, jc=jc, tm=port_model(jm),
             tr=port_model(jr), tw=port_wave(jw), tc=port_case(jc))
    d["prep"] = pt.prepare_condensed(d["tm"], d["tr"], N_SEG)
    d["scase"] = pt.LoadCase(Cd=0.9, **BASE)
    jp = sf.refine_model(jm, PCG_SEG)
    tp = port_model(jp)
    Kg = tb.element_stiffness(tp.coords, tp.conn, tp.sections, tp.sect_id,
                              210000.0, 210000.0 / 2.6)[0]
    d["A"] = ta.assemble_bcsr(Kg, ta.build_bcsr_pattern(tp.conn,
                                                        tp.n_nodes))
    d["K"] = ta.assemble_dense(Kg, tp.conn, tp.n_dof)
    rng = np.random.default_rng(0)
    b = rng.normal(size=tp.n_dof) * 1e5 * np.repeat(
        ~np.asarray(jp.fixed_mask), 6)
    d.update(jp=jp, tp=tp, b=b)
    d["pwave"] = sf.make_wave(9.5, 9.4, 50.0, U_c=1.2, model="stokes", N=5)
    d["pcase"] = sf.LoadCase(**{**BASE, "current_dir_deg": 120.0})
    d["tmp"] = tmp_path_factory.mktemp("distributed")
    d["rose"] = (d["tm"], port_wave(sf.airy_wave(17.038, 9.4, 50.0, 1.7)),
                 pt.LoadCase(**BASE, t_analysis=0.34), ROSE)
    return d


def _calls(d, world_size) -> dict:
    """The port's calls of one launch of ``world_size`` ranks, by name
    (the scatter, whose 3 states pad only at 2 ranks, in the 2-rank
    launch)."""
    env = dict(n_steps=6)
    cond = dict(n_steps=6, solve_dtype=F64)
    mh_kw = dict(wave_model="stokes", N=5, n_modes=8, dtype=F64)
    base = pt.LoadCase(**BASE)
    waves7 = pt.stack_waves([d["tw"].case(i % len(HS)) for i in range(7)])
    calls = {
        "env": (pt.design_envelope, (d["tm"], d["tw"], d["tc"]),
                dict(env, mesh=CASES)),
        "cond": (pt.design_envelope_condensed,
                 (d["tm"], d["tr"], N_SEG, d["tw"], d["tc"]),
                 dict(cond, mesh=CASES)),
        "sweep": (pt.parallel.sweep.design_sweep,
                  (d["tm"], d["tw"], d["tc"]), dict(accel="fd", mesh=CASES)),
        "mh_env": (mh.multihost_design_envelope,
                   (d["tm"], HS, 9.4, 50.0, 1.7, base),
                   dict(mh_kw, n_steps=6)),
        "mh_cond": (mh.multihost_design_envelope_condensed,
                    (d["tm"], d["tr"], N_SEG, HS, 9.4, 50.0, 1.7, base),
                    dict(mh_kw, n_steps=6, solve_dtype=F64)),
        "pcg": (tpd.distributed_pcg,
                (d["A"], d["b"], d["tp"].fixed_mask, DOF),
                dict(tol=1e-11, maxiter=20000)),
        "analyze": (pt.analyze, (d["tp"], port_wave(d["pwave"]),
                                 port_case(d["pcase"])),
                    dict(solver="pcg", mesh=DOF, pcg_tol=1e-12,
                         accel="fd")),
        "four": (pt.design_envelope, (d["tm"], d["tw"].case(slice(0, 4)),
                                      d["tc"].case(slice(0, 4))),
                 dict(env, mesh=CASES)),
        "resumed": (pt.design_envelope_resumable,
                    (d["tm"], d["tw"], d["tc"],
                     d["tmp"] / f"resume{world_size}"),
                    dict(env, chunk_size=world_size, mesh=CASES)),
        # 4 headings: 2 a rank at 2 ranks, refused at 3
        "rose": (pt.pushover_rose, d["rose"], dict(ROSE_KW, mesh=HEADINGS)),
        # each rank's own block of a 7-case batch: uneven at 3 ranks
        "seven": (mh.shard_cases_from_local, (mh.PerRank(tuple(
            waves7.case(slice(*comm.block_range(7, r, world_size)))
            for r in range(world_size))), 7, CASES), {}),
    }
    if world_size == 2:
        calls["scatter"] = (pt.scatter_fatigue_spectral,
                            (d["prep"], d["scase"], STATES, 50.0),
                            dict(SCATTER_KW, mesh=CASES))
        calls["dynamic"] = (pt.scatter_fatigue_spectral,
                            (d["prep"], d["scase"], STATES, 50.0),
                            dict(SCATTER_KW, dynamic=True, n_chain_modes=6,
                                 mesh=CASES))
    return calls, waves7


def _launch(d, world_size):
    """Every call of :func:`_calls` in one group of ``world_size`` gloo
    ranks: (every rank's results by name, the 7-case batch)."""
    calls, waves7 = _calls(d, world_size)
    out = mh.spawn_ranks(world_size, list(calls.values()), device="cpu",
                         return_exceptions=True)
    return [dict(zip(calls, r)) for r in out], waves7


@pytest.fixture(scope="module")
def ranks2(data):
    return _launch(data, 2)


@pytest.fixture(scope="module")
def ranks3(data):
    return _launch(data, 3)


@pytest.fixture(scope="module")
def unsharded(data):
    """The port's unsharded calls in this process."""
    d = data
    return dict(
        env=pt.design_envelope(d["tm"], d["tw"], d["tc"], n_steps=6),
        cond=pt.design_envelope_condensed(d["tm"], d["tr"], N_SEG, d["tw"],
                                          d["tc"], n_steps=6,
                                          solve_dtype=F64),
        sweep=pt.parallel.sweep.design_sweep(d["tm"], d["tw"], d["tc"],
                                             accel="fd"),
        scatter=pt.scatter_fatigue_spectral(d["prep"], d["scase"], STATES,
                                            50.0, **SCATTER_KW),
        dynamic=pt.scatter_fatigue_spectral(d["prep"], d["scase"], STATES,
                                            50.0, dynamic=True,
                                            n_chain_modes=6, **SCATTER_KW))


@pytest.mark.parametrize("world_size", [2, 3])
def test_every_rank_returns_the_same_bits(request, world_size):
    out, _ = request.getfixturevalue(f"ranks{world_size}")
    assert len(out) == world_size
    for r in range(1, world_size):
        for name, a in out[0].items():
            b = out[r][name]
            if isinstance(a, Exception):
                assert type(a) is type(b) and str(a) == str(b), name
            else:
                assert same(a, b), (r, name)


ENV_FIELDS = ("ts", "utilization", "max_util_per_phase", "max_util_per_case",
              "critical_phase", "governing_case", "member_envelope",
              "total_morison")


@pytest.fixture(scope="module")
def jax_envelopes(data):
    d = data
    mesh = Mesh(np.array(jax.devices()[:2]), ("cases",))
    return (sf.design_envelope(d["jm"], d["jw"], d["jc"], n_steps=6,
                               mesh=mesh),
            sf.design_envelope_condensed(d["jm"], d["jr"], N_SEG, d["jw"],
                                         d["jc"], n_steps=6,
                                         solve_dtype=jnp.float64,
                                         mesh=mesh))


@pytest.mark.parametrize("world_size", [2, 3])
def test_envelopes_match_jax_and_unsharded(request, data, unsharded,
                                           world_size):
    """The dense envelope (1e-10) and the condensed one (1e-12) against
    JAX's on a 2-device mesh, both bit-equal to the port's unsharded
    calls; the multi-host envelopes, which build each rank's waves from H,
    equal them to 1e-12, and so does the resumable envelope, chunked and
    sharded."""
    out = request.getfixturevalue(f"ranks{world_size}")[0][0]
    ref, jcond = request.getfixturevalue("jax_envelopes")
    for f in ENV_FIELDS:
        assert rel_err(getattr(out["env"], f), getattr(ref, f)) < 1e-10, f
        if getattr(jcond, f) is not None:
            assert rel_err(getattr(out["cond"], f),
                           getattr(jcond, f)) < 1e-12, f
        for key in ("env", "cond"):
            assert same(getattr(out[key], f), getattr(unsharded[key], f)), \
                (key, f)
        # chunks of world_size cases
        assert rel_err(getattr(out["resumed"], f),
                       getattr(unsharded["env"], f)) < 1e-12, f
    for name, key in (("mh_env", "env"), ("mh_cond", "cond")):
        for f in ("max_util_per_case", "member_envelope", "total_morison"):
            assert rel_err(getattr(out[name], f),
                           getattr(unsharded[key], f)) < 1e-12, (key, f)


def test_sweep_and_scatter_match_unsharded(ranks2, data, unsharded):
    """design_sweep against JAX's sharded sweep (1e-10) and the unsharded
    one (U bit-equal, the rest 1e-12); the scatter's 3 states over 2 ranks (one padding
    state) bit-equal to the unsharded diagram, quasi-static and
    dynamic."""
    out = ranks2[0][0]
    d = data
    mesh = Mesh(np.array(jax.devices()[:2]), ("cases",))
    ref = jsweep.design_sweep(d["jm"], d["jw"], d["jc"], accel="fd",
                              mesh=mesh)
    for f in ("U", "reactions", "utilization", "max_displacement_mm"):
        assert rel_err(getattr(out["sweep"], f), getattr(ref, f)) < 1e-10, f
    assert same(out["sweep"].U, unsharded["sweep"].U)
    for f in ("reactions", "F1_local", "F2_local", "utilization"):
        assert rel_err(getattr(out["sweep"], f),
                       getattr(unsharded["sweep"], f)) < 1e-12, f
    crit = pt.parallel.sweep.critical_case(out["sweep"])
    assert int(crit["index"]) == len(HS) - 1
    for key in ("scatter", "dynamic"):
        assert out[key].per_state_wl.shape == (len(STATES),
                                               d["prep"].refined.n_members)
        for f in ("damage_nb", "damage_wl", "mpm_utilization",
                  "per_state_wl", "per_state_sigma", "per_state_nu0"):
            a, b = getattr(out[key], f), getattr(unsharded[key], f)
            # each rank builds the Craig-Bampton basis itself, on its
            # share of the host's threads: 1e-12, the JAX test's limit
            assert same(a, b) if key == "scatter" else rel_err(a, b) < 1e-12,\
                (key, f, rel_err(a, b))


def test_distributed_pcg_matches_jax_and_dense(ranks2, ranks3, data):
    """2 ranks against JAX's distributed PCG on 2 devices (iterations
    within 1%, U within 1e-9 of max |U|) and against the dense Cholesky
    (rtol 1e-7); 3 ranks likewise against the dense solve; fixed DOFs
    exactly 0."""
    d = data
    jp = d["jp"]
    Kg = j_es(jp.coords, jp.conn, jp.sections, jp.sect_id, 210000.0,
              210000.0 / 2.6)[0]
    jA = ja.assemble_bcsr(Kg, ja.build_bcsr_pattern(jp.conn, jp.n_nodes))
    mesh = Mesh(np.array(jax.devices()[:2]), ("dof",))
    ju, jit, _ = jpd.distributed_pcg(jA, jnp.asarray(d["b"]), jp.fixed_mask,
                                     mesh, tol=1e-11, maxiter=20000)
    free, fixed = ts.free_fixed_dofs(d["tp"].fixed_mask)
    u_ref = ts.solve_dense(d["K"], torch.as_tensor(d["b"]), free)
    scale = float(u_ref.abs().max())
    for out in (ranks2[0][0], ranks3[0][0]):
        u, it, res = out["pcg"]
        assert float(res) < 1e-10
        assert abs(int(it) / int(jit) - 1.0) <= 0.01
        assert float((u - u_ref).abs().max()) <= 1e-7 * scale + 1e-7 * (
            u_ref.abs())[(u - u_ref).abs().argmax()]
        assert float(u[fixed].abs().max()) == 0.0
    assert float((ranks2[0][0]["pcg"][0] - torch.tensor(np.asarray(ju)))
                 .abs().max()) <= 1e-9 * scale


def test_analyze_pcg_mesh_matches_chol_and_jax(ranks2, data):
    """analyze(solver="pcg", mesh=) against the port's Cholesky solve
    (JAX's limits: U at 1e-7 x max |U|, utilization at 1e-6);
    solver="chol" with a mesh raises."""
    d = data
    res = ranks2[0][0]["analyze"]
    chol = pt.analyze(d["tp"], port_wave(d["pwave"]), port_case(d["pcase"]),
                      solver="chol", accel="fd")
    scale = float(chol.U.abs().max())
    assert float((res.U - chol.U).abs().max()) <= 1e-7 * scale
    assert rel_err(res.utilization, chol.utilization) < 1e-6
    assert int(res.solver_iters) > 0 and float(res.solver_residual) <= 1e-12
    with pytest.raises(ValueError, match="requires solver='pcg'"):
        pt.analyze(d["tp"], port_wave(d["pwave"]), port_case(d["pcase"]),
                   solver="chol", mesh=object())


@pytest.mark.parametrize("world_size", [2, 3])
def test_case_counts_and_uneven_blocks(request, data, world_size):
    """4 cases divide 2 ranks and not 3 (ValueError, as JAX's P('cases')
    placement refuses them); 7 cases gathered from uneven rank blocks
    give the whole batch."""
    out, waves7 = request.getfixturevalue(f"ranks{world_size}")
    four, seven = out[0]["four"], out[0]["seven"]
    if world_size == 2:
        ref = pt.design_envelope(data["tm"], data["tw"].case(slice(0, 4)),
                                 data["tc"].case(slice(0, 4)), n_steps=6)
        assert same(four.max_util_per_case, ref.max_util_per_case)
    else:
        assert isinstance(four, ValueError) and "divide" in str(four)
    for f in ("k", "omega", "H", "T", "E", "U"):
        assert torch.equal(getattr(seven, f), getattr(waves7, f)), f


@pytest.mark.parametrize("world_size", [2, 3])
def test_pushover_rose_sharded_matches_unsharded(request, data, world_size):
    """``pushover_rose(mesh=)``: 4 headings in blocks of 2 over 2 ranks
    give the unsharded rose's RSR and first yield exactly and its curves
    (converged and yielded counts exactly, the rest 1e-12: a rank's batch
    is half the states, and the batched products round with its size);
    3 ranks refuse 4 headings (ValueError, as JAX's placement does)."""
    out = request.getfixturevalue(f"ranks{world_size}")[0][0]["rose"]
    if world_size == 3:
        assert isinstance(out, ValueError) and "divide" in str(out)
        return
    headings, rsr, fy, per = pt.pushover_rose(*data["rose"], **ROSE_KW)
    h, rsr_sh, fy_sh, curve = out
    assert np.array_equal(h, headings)
    assert np.array_equal(rsr_sh, rsr) and np.array_equal(fy_sh, fy)
    conv, disp, ny, util, axial = curve
    assert disp.shape == (4, ROSE_KW["n_lambda"])
    for i, r in enumerate(per):
        assert torch.equal(conv[i], r.converged)
        assert torch.equal(ny[i], r.n_yielded)
        for a, b in ((disp[i], r.max_displacement_mm),
                     (util[i], r.max_util), (axial[i], r.axial_N)):
            assert rel_err(a, b) < 1e-12


def test_shard_bcsr_round_trip(data):
    """Every block appears once across the slabs, each in its own row;
    padded rows are empty."""
    A = data["A"]
    for W in (2, 3, 8):
        S = tpd.shard_bcsr(A, W)
        assert sum(S.counts) == A.pattern.n_blocks
        assert S.n_nodes_padded % W == 0
        rows = torch.cat([S.local_rows[r, :S.counts[r]] + r * S.rows_per_dev
                          for r in range(W)])
        cols = torch.cat([S.cols[r, :S.counts[r]] for r in range(W)])
        blocks = torch.cat([S.blocks[r, :S.counts[r]] for r in range(W)])
        K = torch.zeros(S.n_nodes_padded, 6, S.n_nodes_padded, 6,
                        dtype=F64)
        K[rows, :, cols, :] = blocks
        n = A.pattern.n_nodes
        assert torch.equal(K[:n, :, :n].reshape(6 * n, 6 * n),
                           ta.bcsr_to_dense(A))


def test_multihost_on_one_process(data):
    """Without a process group: init_multihost() is a no-op returning
    False, no global mesh, the local slice is everything, and the
    multi-host envelopes equal the plain ones."""
    assert not dist.is_initialized()
    assert mh.init_multihost() is False
    assert mh.global_case_mesh() is None
    assert mh.process_local_slice(10) == slice(0, 10)
    env = mh.multihost_design_envelope(
        data["tm"], HS, 9.4, 50.0, 1.7, pt.LoadCase(**BASE),
        wave_model="stokes", N=5, n_modes=8, n_steps=4, dtype=F64)
    waves = pt.make_wave_batch(HS, 9.4, 50.0, dtype=F64, device="cpu",
                               **WAVE_KW)
    cases = pt.make_case_batch(pt.LoadCase(**BASE),
                               t_analysis=np.zeros(len(HS)))
    ref = pt.design_envelope(data["tm"], waves, cases, n_steps=4)
    assert same(env.max_util_per_case, ref.max_util_per_case)
    cond = mh.multihost_design_envelope_condensed(
        data["tm"], data["tr"], N_SEG, HS, 9.4, 50.0, 1.7,
        pt.LoadCase(**BASE), wave_model="stokes", N=5, n_modes=8, n_steps=4,
        dtype=F64, solve_dtype=F64)
    ref = pt.design_envelope_condensed(data["tm"], data["tr"], N_SEG, waves,
                                       cases, n_steps=4, solve_dtype=F64)
    assert same(tuple(cond), tuple(ref))


def test_single_rank_group_and_mesh_refusals(data, tmp_path):
    """A one-rank gloo group in this process: the sharded condensed
    envelope is bit-equal to the unsharded call.  A mesh of the wrong
    kind raises TypeError, a mesh whose group is gone ValueError, and so
    does distributed_pcg on a mesh without its axis."""
    d = data
    for bad in (object(), "cases", 2):
        with pytest.raises(TypeError, match="DeviceMesh"):
            pt.design_envelope_condensed(d["tm"], d["tr"], N_SEG, d["tw"],
                                         d["tc"], n_steps=2, mesh=bad)
    assert mh.init_multihost(f"file://{tmp_path}/store", world_size=1,
                             rank=0) is True
    try:
        mesh = mh.global_case_mesh()
        kw = dict(n_steps=2, solve_dtype=F64)
        one = pt.design_envelope_condensed(d["tm"], d["tr"], N_SEG, d["tw"],
                                           d["tc"], mesh=mesh, **kw)
        ref = pt.design_envelope_condensed(d["tm"], d["tr"], N_SEG, d["tw"],
                                           d["tc"], **kw)
        assert same(tuple(one), tuple(ref))
        with pytest.raises(ValueError, match="axis 'dof'"):
            tpd.distributed_pcg(d["A"], d["b"], d["tp"].fixed_mask, mesh)
    finally:
        dist.destroy_process_group()
    with pytest.raises(ValueError, match="process group"):
        pt.design_envelope(d["tm"], d["tw"], d["tc"], mesh=mesh)


def test_concurrent_builds_compile_once(tmp_path, monkeypatch):
    """Two processes that reach the mesh kit's first-use build at once
    (the ranks of a group) compile it once under the build lock, leave no
    temporary file, and both load the same library; the CUDA kernels'
    build takes the same lock."""
    import ctypes
    import multiprocessing as mp
    import shutil
    import stat

    from small_fem_solver_tpu_torch import native

    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    log = tmp_path / "compiles.log"
    wrapper = tmp_path / "cxx.sh"
    wrapper.write_text(f'#!/bin/sh\necho run >> "{log}"\nexec "{cxx}" "$@"\n')
    wrapper.chmod(wrapper.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CXX", str(wrapper))
    build_dir = tmp_path / "build"
    with mp.get_context("spawn").Pool(2) as pool:
        paths = pool.map(native._build, [build_dir, build_dir])
    assert paths[0] == paths[1] and paths[0] is not None
    assert log.read_text().splitlines() == ["run"]
    assert sorted(p.name for p in build_dir.iterdir()) == sorted(
        [".lock", paths[0].name])
    assert ctypes.CDLL(str(paths[0])).rainflow_damage_sums is not None
    from small_fem_solver_tpu_torch.ops import hopper_kernels
    assert hopper_kernels.build_lock is native.build_lock
