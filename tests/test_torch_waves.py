"""PyTorch port vs the JAX package: dispersion, Airy and Fenton waves (f64,
CPU).  Coefficients agree to 1e-10 relative."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import small_fem_solver_tpu as sf
import small_fem_solver_tpu_torch as pt

TOL = 1e-10
WAVE_FIELDS = ("k", "omega", "c", "d", "U_c", "H", "T", "E", "U")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _assert_wave(tw, jw):
    for f in WAVE_FIELDS:
        assert _rel(getattr(tw, f).numpy(), getattr(jw, f)) < TOL, f
    assert (tw.clamp_z, tw.model, tw.order) == (jw.clamp_z, jw.model,
                                                jw.order)


def test_solve_dispersion_matches_jax():
    rng = np.random.default_rng(0)
    omega = rng.uniform(0.2, 3.0, size=64)
    d = rng.uniform(5.0, 300.0, size=64)
    k = pt.solve_dispersion(torch.tensor(omega), torch.tensor(d)).numpy()
    assert _rel(k, sf.solve_dispersion(jnp.asarray(omega),
                                       jnp.asarray(d))) < TOL


@pytest.mark.parametrize("n_modes", [1, 4])
def test_airy_wave_matches_jax(n_modes):
    args = (17.038, 9.4, 50.0, 1.7)
    _assert_wave(pt.airy_wave(*args, n_modes=n_modes),
                 sf.airy_wave(*args, n_modes=n_modes))


def test_fenton_wave_n18_matches_jax():
    """The flagship storm wave (H = 17.038 m, T = 9.4 s, d = 50 m,
    U_c = 1.7 m/s) at N = 18, through make_wave as the bench builds it."""
    args = (17.038, 9.4, 50.0)
    tw = pt.make_wave(*args, U_c=1.7, model="fenton", N=18)
    jw = sf.make_wave(*args, U_c=1.7, model="fenton", N=18)
    _assert_wave(tw, jw)


def test_fenton_wave_float32_cast_and_padding():
    """The f64 host solve is cast to the requested dtype; n_modes pads."""
    tw = pt.fenton_wave(9.5, 9.4, 50.0, 1.2, N=12, n_modes=16,
                        dtype=torch.float32)
    jw = sf.fenton_wave(9.5, 9.4, 50.0, 1.2, N=12, n_modes=16,
                        dtype=jnp.float32)
    assert tw.E.dtype == torch.float32 and tw.E.shape == (16,)
    for f in WAVE_FIELDS:
        np.testing.assert_allclose(getattr(tw, f).numpy(),
                                   np.asarray(getattr(jw, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)


def test_unported_wave_models_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pt.make_wave(9.5, 9.4, 50.0, model="stokes", N=5)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pt.make_wave(9.5, 9.4, 50.0)
    with pytest.raises(ValueError):
        pt.make_wave(9.5, 9.4, 50.0, model="cnoidal")
