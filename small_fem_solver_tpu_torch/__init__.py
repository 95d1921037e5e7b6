"""small_fem_solver_tpu_torch — the PyTorch/CUDA port of small_fem_solver_tpu.

Offshore-jacket structural analysis (wave kinematics -> Morison loading ->
3D Timoshenko beam FEM -> stresses) in PyTorch, with the JAX package's
Pallas TPU kernels rewritten by hand for NVIDIA Hopper.  This release
carries the reference analysis (``analyze`` with LU or Cholesky,
``analyze_phase_batch``), the condensed single-phase analyses
(``analyze_condensed``, ``analyze_prepared``), the condensed phase scan
(fused, separable or pointwise kinematics) and the condensed design
envelope: Airy, Stokes (orders 1-5) and Fenton waves with the reference's
automatic selection, pointwise kinematics and Morison loads (slamming
included), the default jacket, JSON-style models and their refinements,
the fused Morison kernel and the chain-sweep kernel (CUDA C++) with their
plain PyTorch versions, and the exact chain-condensation solver.  The
package imports no JAX; ``convert`` carries state over from the JAX
package.  Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (:func:`resolve_device`).
"""

from .api import (AnalysisResults, CondensedPrepared, CondensedScanResults,
                  EnvelopeResults, LoadCase, analyze, analyze_condensed,
                  analyze_phase_batch, analyze_prepared,
                  design_envelope_condensed, phase_scan_condensed,
                  phase_scan_prepared, prepare_condensed)
from .constants import (DEFAULT_E, DEFAULT_FY, DEFAULT_NU, DEFAULT_RHO_STEEL,
                        DEFAULT_RHO_WATER, G_GRAV)
from .device import resolve_device
from .models.model import JacketModel, build_model, refine_model
from .models.presets import DEFAULT_STORM, default_3leg_jacket
from .ops.dispersion import solve_dispersion
from .ops.fenton import fenton_wave, fenton_wave_batch
from .ops.morison import MorisonLoads, PhaseScan, morison_loads, phase_scan
from .ops.sections import TubeSections, tube_sections
from .ops.stokes import stokes_wave
from .ops.wave_models import airy_steepness, make_wave, validate_wave
from .ops.waves import (FourierWave, airy_wave, kinematics,
                        surface_elevation, surface_velocity)
from .parallel.sweep import make_case_batch, make_wave_batch, stack_waves

__version__ = "0.1.0"
