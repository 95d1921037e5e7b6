"""Physical constants and default material parameters.

Same values as ``small_fem_solver_tpu/constants.py`` (the reference tool's
module-level constants), so default analyses are numerically identical.

Unit conventions (same as the reference, documented in its Info tab at
`JacketAnalysisGUI_v2.py:1737-1751`):

- geometry input:  metres
- section input:   millimetres (D, t)
- FEM internal:    N / mm / MPa  (lengths mm, forces N, moments N*mm)
- hydrodynamics:   SI (kg/m^3, m, s) -> forces come out in N
- user-facing I/O: kN, kN*m, MPa
"""

G_GRAV = 9.81  # m/s^2

DEFAULT_RHO_WATER = 1025.0   # kg/m^3
DEFAULT_E = 210000.0         # MPa
DEFAULT_NU = 0.3
DEFAULT_FY = 355.0           # MPa
DEFAULT_RHO_STEEL = 7850.0   # kg/m^3
