"""PyTorch port vs the JAX package: the Craig-Bampton paths of the
irregular-sea slice, on the 2x refined default jacket with every chain
mode kept (the sizes and the 1e-10 of ``test_torch_dynamics.py`` for the
same reduction; a cut inside a degenerate bending pair would leave the
kept basis to roundoff):

- ``spectral_transfer_dynamic`` / ``spectral_response_dynamic``, modal
  and Rayleigh damping: 1e-10 (mean and MPM stresses to a tied governing
  point, as in ``test_torch_spectrum.py``);
- ``scatter_fatigue_spectral(dynamic=True)`` over three states and its
  long-term extremes: 1e-10;
- ``transient_response_condensed`` driven by a long-crested sea, with and
  without relative drag: 1e-10.

The helpers and the seas come from ``test_torch_spectrum.py``.
"""
import pytest

import small_fem_solver_tpu as sf
import small_fem_solver_tpu_torch as pt
from test_torch_convert import port_case, rel_err
from test_torch_spectrum import (CB_SEG, CHAIN_MODES, STORM, assert_stats,
                                 check_scatter_spectral, make_jacket)


@pytest.fixture(scope="module")
def jacket():
    return make_jacket(CB_SEG)


@pytest.mark.parametrize("damping", ["modal", "rayleigh"])
def test_spectral_response_dynamic_matches_jax(jacket, damping):
    """The Craig-Bampton dynamic transfer rows and response at 1e-10."""
    js, ts_ = jacket["seas"]["long"]
    case = sf.LoadCase(**STORM)
    kw = dict(damping=damping, n_chain_modes=CHAIN_MODES)
    rows = sf.spectral_transfer_dynamic(jacket["jc"], jacket["jr"], CB_SEG,
                                        js, case, prep=jacket["jprep"], **kw)
    out = pt.spectral_transfer_dynamic(jacket["tc"], jacket["tr"], CB_SEG,
                                       ts_, port_case(case),
                                       prep=jacket["tprep"], **kw)
    for name in out._fields:
        assert rel_err(getattr(out, name), getattr(rows, name)) < 1e-10, name
    ref = sf.spectral_response_dynamic(jacket["jc"], jacket["jr"], CB_SEG,
                                       js, case, prep=jacket["jprep"], **kw)
    out = pt.spectral_response_dynamic(jacket["tc"], jacket["tr"], CB_SEG,
                                       ts_, port_case(case),
                                       prep=jacket["tprep"], **kw)
    assert_stats(out, ref, rows, 1e-10)
    with pytest.raises(ValueError, match="damping"):
        pt.spectral_response_dynamic(jacket["tc"], jacket["tr"], CB_SEG, ts_,
                                     port_case(case), damping="viscous")


def test_scatter_fatigue_spectral_dynamic_matches_jax(jacket):
    """The dynamic frequency-domain scatter and its long-term extremes at
    1e-10."""
    check_scatter_spectral(jacket["jprep"], jacket["tprep"], jacket["jc"],
                           jacket["jr"], CB_SEG, True, 1e-10)


@pytest.mark.parametrize("variant", ["loads", "relative_drag"])
def test_sea_transient_matches_jax(jacket, variant):
    """The transient response to a long-crested sea (16 components, 48
    steps of 0.2 s, ramped over one Tp), and with relative drag, at
    1e-10; a spread sea with relative drag raises as in JAX, and a sea on
    the harmonic path as the port's type check."""
    js, ts_ = jacket["seas"]["long"]
    case = sf.LoadCase(**STORM)
    kw = dict(dt=0.2, n_steps=48, ramp_periods=1.0,
              n_chain_modes=CHAIN_MODES,
              relative_drag=variant == "relative_drag")
    ref = sf.transient_response_condensed(jacket["jc"], jacket["jr"], CB_SEG,
                                          js, case, **kw)
    out = pt.transient_response_condensed(jacket["tc"], jacket["tr"], CB_SEG,
                                          ts_, port_case(case), **kw)
    for name in ("ts", "U_time", "utilization", "tip_displacement_mm"):
        assert rel_err(getattr(out, name), getattr(ref, name)) < 1e-10, name
    if variant == "relative_drag":
        with pytest.raises(ValueError, match="long-crested"):
            pt.transient_response_condensed(
                jacket["tc"], jacket["tr"], CB_SEG,
                jacket["seas"]["spread"][1], port_case(case), **kw)
    with pytest.raises(TypeError, match="FourierWave"):
        pt.dynamic_response_condensed(jacket["tc"], jacket["tr"], CB_SEG, ts_,
                                      port_case(case))
