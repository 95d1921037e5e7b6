"""The system under test: the PyTorch and CUDA port, set up from a
configuration file and a traffic mix.  Everything here goes through the
port's public entry points; the entries (``entries/<name>.py``) make the
calls."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

DTYPES = {"float32": torch.float32, "float64": torch.float64}


@dataclasses.dataclass
class SUT:
    pt: object                 # the port's package
    config: dict
    mix: dict
    device: torch.device
    dtype: torch.dtype         # loads (the model's dtype)
    solve_dtype: torch.dtype
    coarse: object             # JacketModel
    refined: object            # JacketModel (the coarse one when n_seg 1)
    n_seg: int
    waves: object              # FourierWave batch of the mix's wave set
    base_case: object          # LoadCase


def model_tables(config: dict):
    """(nodes, members, supports, top nodes) of a configuration in the
    port's ``build_model`` form, z from the mean water level."""
    zr = config["z_water_ref_m"]
    nodes = {n: (x, y, z - zr) for n, (x, y, z) in config["nodes"].items()}
    members = [{"name": f"{a}-{b}#{i}", "node1": a, "node2": b, "type": kind}
               for i, (a, b, kind) in enumerate(config["members"])]
    return nodes, members, config["supports"], config["top"]


def build(pt, config: dict, mix: dict, H: np.ndarray, device) -> SUT:
    """The port's model, its refinement, the wave set of heights ``H`` (the
    port's own wave set-up: Fenton's Newton or the Stokes dispersion on the
    host, coefficients on ``device``) and the load case."""
    dtype = DTYPES[config["precision"]["loads"]]
    nodes, members, supports, top = model_tables(config)
    sec = config["sections_mm"]
    mat, sea, topside = config["material"], config["sea"], config["topside"]
    coarse = pt.build_model(nodes, members, supports, top,
                            leg_section=tuple(sec["leg"]),
                            brace_section=tuple(sec["brace"]),
                            rho_steel=mat["rho_steel_kg_m3"], dtype=dtype,
                            device=device)
    n_seg = int(config["mesh"]["n_seg"])
    refined = pt.refine_model(coarse, n_seg) if n_seg > 1 else coarse
    wave = config["wave"]
    waves = pt.make_wave_batch(H, sea["T_s"], sea["d_m"], U_c=sea["U_c_ms"],
                               model=wave["model"], N=wave["N"],
                               n_modes=wave["n_modes"], dtype=dtype,
                               device=device)
    case = pt.LoadCase(
        E=mat["E_MPa"], nu=mat["nu"], fy=mat["fy_MPa"],
        rho_water=sea["rho_water_kg_m3"], Cd=sea["Cd"], Cm=sea["Cm"],
        F_axial_kN=topside["F_axial_kN"], F_shear_kN=topside["F_shear_kN"],
        custom_sw_tonnes=topside["self_weight_t"], sw_mode="custom",
        **mix.get("case", {}))
    return SUT(pt=pt, config=config, mix=mix, device=torch.device(device),
               dtype=dtype,
               solve_dtype=DTYPES[config["precision"]["solve"]],
               coarse=coarse, refined=refined, n_seg=n_seg, waves=waves,
               base_case=case)


def pick_waves(waves, idx: np.ndarray):
    """Waves ``idx`` of a batch, as a batch (an index on the device)."""
    i = torch.as_tensor(idx, device=waves.k.device)
    return dataclasses.replace(waves, **{
        f.name: getattr(waves, f.name)[i] for f in dataclasses.fields(waves)
        if isinstance(getattr(waves, f.name), torch.Tensor)})


def build_kernels(sut: SUT) -> None:
    """Build (or load) the port's CUDA kernel libraries: set-up work."""
    if sut.device.type == "cuda":
        sut.pt.ops.hopper_kernels.build_all()


def host(x) -> np.ndarray:
    """A result on the host, as the port's command line brings it there."""
    from small_fem_solver_tpu_torch.utils.io import _np
    return _np(x)
