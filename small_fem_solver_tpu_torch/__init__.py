"""small_fem_solver_tpu_torch — the PyTorch/CUDA port of small_fem_solver_tpu.

Offshore-jacket structural analysis (wave kinematics -> Morison loading ->
3D Timoshenko beam FEM -> stresses) in PyTorch, with the JAX package's
Pallas TPU kernels rewritten by hand for NVIDIA Hopper.  This release
carries the condensed phase scan: Airy and Fenton waves, the default jacket
and its refinements, the fused Morison kernel (CUDA C++) and its plain
PyTorch version, and the exact chain-condensation solver.  The package
imports no JAX; ``convert`` carries state over from the JAX package.
"""

from .api import (CondensedPrepared, CondensedScanResults, LoadCase,
                  phase_scan_condensed, phase_scan_prepared,
                  prepare_condensed)
from .constants import (DEFAULT_E, DEFAULT_FY, DEFAULT_NU, DEFAULT_RHO_STEEL,
                        DEFAULT_RHO_WATER, G_GRAV)
from .models.model import JacketModel, build_model, refine_model
from .models.presets import DEFAULT_STORM, default_3leg_jacket
from .ops.dispersion import solve_dispersion
from .ops.fenton import fenton_wave
from .ops.sections import TubeSections, tube_sections
from .ops.wave_models import make_wave
from .ops.waves import FourierWave, airy_wave

__version__ = "0.1.0"
