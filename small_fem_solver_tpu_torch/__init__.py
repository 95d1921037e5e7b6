"""small_fem_solver_tpu_torch — the PyTorch/CUDA port of small_fem_solver_tpu.

Offshore-jacket structural analysis (wave kinematics -> Morison loading ->
3D Timoshenko beam FEM -> stresses) in PyTorch, with the JAX package's
Pallas TPU kernels rewritten by hand for NVIDIA Hopper.  This release
carries the reference analysis (``analyze`` with LU or Cholesky,
``analyze_phase_batch``, ``analyze_ssi`` on foundation springs), the
condensed single-phase analyses (``analyze_condensed``,
``analyze_prepared``), the condensed phase scan (fused, separable or
pointwise kinematics), the design envelopes (dense ``design_envelope``,
``design_envelope_condensed``, ``parallel.sweep.design_sweep``, resumable
envelopes with npz persistence), the model and load options (member
end releases, appurtenances, still-water buoyancy, wind and foundation
springs), structural dynamics: modal analysis (dense and
Craig-Bampton), harmonic and transient response, and fatigue screening,
and irregular seas: random-sea scans (condensed and dense), the
frequency-domain transfer and response (quasi-static and dynamic),
time- and frequency-domain scatter fatigue, long-term extremes and
sea-driven transients, second-order analysis (P-delta, dense and
condensed) and buckling (linearized global, Craig-Bampton reduced, member
Euler screen), and the case-, state- and row-sharded paths on
``torch.distributed`` (``mesh=``, ``parallel.multihost``,
``parallel.pcg_dist``), and the design tier run after the storm
envelope: API p-y / t-z pile springs from the soil
(``soil_support_stiffness``), the response-spectrum seismic check (dense
and Craig-Bampton), the pushover and its heading rose (RSR), the
member-removal screen, the API RP 2A and ISO 19902 member checks, the API
joint check, the VIV screen, the air gap and load combinations, and the
long-term tier: joint (Hs, Tp) climates and IFORM contours, FORM / SORM /
importance-sampling reliability of the system and of every member on
batched design envelopes, section sensitivities and gradient sizing
through autograd, and (in ``utils``) model JSON, CSV, text reports and
plots (matplotlib, imported by ``utils.plotting`` only), and the
command line (``python -m small_fem_solver_tpu_torch.cli``, the JAX
package's 23 subcommands) and the Tk GUI (``python -m
small_fem_solver_tpu_torch.gui``; its headless core imports no Tk).  Waves:
Airy, Stokes (orders 1-5) and Fenton with the reference's automatic
selection.  The fused Morison kernel and the
chain-sweep kernel (CUDA C++) have plain PyTorch versions beside them.
The package imports no JAX; ``convert`` carries state over from the JAX
package.  Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (:func:`resolve_device`).
"""

from .api import (AnalysisResults, CondensedPrepared, CondensedScanResults,
                  EnvelopeResults, FreqTransfer, LoadCase, LongTermExtremes,
                  ScatterFatigue, ScatterFatigueSpectral, analyze,
                  analyze_condensed, analyze_pdelta, analyze_pdelta_condensed,
                  analyze_phase_batch, analyze_prepared, analyze_ssi, design_envelope, design_envelope_condensed,
                  long_term_extremes, phase_scan_condensed,
                  phase_scan_prepared, prepare_condensed, scatter_fatigue,
                  scatter_fatigue_spectral, sea_response_batch,
                  sea_scan_prepared, spectral_response_dynamic,
                  spectral_response_prepared, spectral_transfer_dynamic,
                  spectral_transfer_prepared)
from .constants import (DEFAULT_E, DEFAULT_FY, DEFAULT_NU, DEFAULT_RHO_STEEL,
                        DEFAULT_RHO_WATER, G_GRAV)
from .device import resolve_device
from .models.model import (JacketModel, add_appurtenances, build_model,
                           refine_model)
from .models.presets import DEFAULT_STORM, default_3leg_jacket
from .ops.buckling import (BucklingResults, EulerScreen, buckling_analysis,
                           buckling_analysis_condensed,
                           element_geometric_stiffness, euler_member_screen)
from .ops.airgap import AirGapResult, air_gap_check
from .ops.codecheck import CodeCheck, member_code_check
from .ops.design import (SectionSensitivities, SizingResult,
                         optimize_sections, section_sensitivities)
from .ops.codecheck_iso import ISOCheck, iso_member_check
from .ops.dispersion import apparent_period, solve_dispersion
from .ops.dynamics import (HarmonicResponse, ModalResults,
                           TransientResponse, dynamic_response,
                           dynamic_response_condensed, mac, modal_analysis,
                           modal_analysis_condensed,
                           transient_response_condensed)
from .ops.eigen import (eigh_general_small, jacobi_eigh, subspace_eigh,
                        subspace_largest)
from .ops.fatigue import FatigueScreen, fatigue_screen
from .ops.fenton import fenton_wave, fenton_wave_batch
from .ops.freqdomain import (FreqDomainResponse, LinearizedSeaLoads,
                             linearized_sea_loads, spectral_stats)
from .ops.jointcheck import JointCheck, joint_code_check
from .ops.metocean import (JointHsTp, fit_joint_hs_tp, fit_weibull,
                           iform_contour, n_year_sea_states,
                           return_period_beta, rosenblatt_hs_tp)
from .ops.morison import MorisonLoads, PhaseScan, morison_loads, phase_scan
from .ops.pushover import PushoverResults, pushover, pushover_rose
from .ops.reliability import (EnvironmentalReliability, FormResult,
                              MemberReliability, SystemReliability,
                              bivariate_normal_cdf, ditlevsen_bounds,
                              environmental_reliability, form,
                              hs_tp_limit_state, hs_tp_limit_state_batch,
                              importance_sample, importance_sample_batch,
                              member_reliability,
                              member_utilization_response_batch,
                              sorm_correction, utilization_response,
                              utilization_response_batch)
from .ops.robustness import RemovalScreen, member_removal_screen
from .ops.sections import TubeSections, tube_sections, validate_sections
from .ops.seismic import (SpectrumResults, cqc_correlation, ec8_spectrum,
                          response_spectrum, response_spectrum_condensed,
                          table_spectrum)
from .ops.soil import (Pile, PileHeadStiffness, SoilLayer, axial_solve,
                       lateral_solve, pile_head_stiffness,
                       soil_support_stiffness)
from .ops.spectrum import (SeaKinematics, SpectralFatigue, SpectralSea,
                           jonswap_shape, make_random_sea, morison_sea_batch,
                           pm_shape, sea_kinematics, sea_surface,
                           spectral_fatigue_screen)
from .ops.stokes import stokes_wave
from .ops.viv import VIVScreen, viv_screen
from .ops.wave_models import airy_steepness, make_wave, validate_wave
from .ops.waves import (FourierWave, airy_wave, kinematics,
                        surface_elevation, surface_velocity)
from .ops.wind import wind_member_forces, wind_profile, wind_topside_force
from .parallel.sweep import make_case_batch, make_wave_batch, stack_waves
from .utils.combos import combine_results, combo_envelope
from .utils.persist import (design_envelope_resumable, load_results,
                            save_results)

__version__ = "0.1.0"
