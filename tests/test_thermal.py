"""Thermal emission kernel physics checks.

The reference has no thermal unit tests (its golden thermal comparisons run
against external pyDISORT output, model_compare.py:20-106); here we anchor
the kernel with closed-form limits instead.
"""

import jax.numpy as jnp
import numpy as np

from picaso_tpu import disco
from picaso_tpu.rt import toon


def _setup(nlevel=40, nwno=8, T=900.0, dtau_total=50.0, w0=1e-6):
    wno = np.linspace(3000.0, 9000.0, nwno)
    tlevel = np.zeros(nlevel) + T
    plevel = np.logspace(-3, 2, nlevel) * 1e6
    dtau = np.zeros((nlevel - 1, nwno)) + dtau_total / (nlevel - 1)
    w0m = np.zeros_like(dtau) + w0
    cosb = np.zeros_like(dtau)
    return wno, tlevel, plevel, dtau, w0m, cosb


def test_isothermal_blackbody_limit():
    """Optically thick isothermal, no scattering -> TOA flux = pi*B(T)."""
    wno, tlevel, plevel, dtau, w0m, cosb = _setup()
    geom = disco.make_geometry(0, num_gangle=10, num_tangle=1)
    flux_top, _ = toon.thermal_1d(
        jnp.asarray(tlevel), jnp.asarray(dtau), jnp.asarray(w0m),
        jnp.asarray(cosb), jnp.asarray(plevel), jnp.asarray(geom.ubar1),
        jnp.zeros(len(wno)), jnp.asarray(wno), dwno=jnp.zeros(len(wno)),
        hard_surface=False, calc_type=0)
    flux = disco.compress_thermal(flux_top, jnp.asarray(geom.gweight),
                                  jnp.asarray(geom.tweight))
    # pi * B_lambda(T) in erg/s/cm^2/cm (the kernel's spectral convention)
    bb = np.pi * np.asarray(toon.blackbody(tlevel[:1], 1.0 / wno))[0]
    np.testing.assert_allclose(np.asarray(flux), bb, rtol=1e-3)


def test_hotter_interior_increases_flux():
    """A positive lapse rate must brighten the emergent spectrum."""
    wno, tlevel, plevel, dtau, w0m, cosb = _setup(dtau_total=5.0)
    geom = disco.make_geometry(0, num_gangle=10, num_tangle=1)

    def run(tl):
        f, _ = toon.thermal_1d(
            jnp.asarray(tl), jnp.asarray(dtau), jnp.asarray(w0m),
            jnp.asarray(cosb), jnp.asarray(plevel), jnp.asarray(geom.ubar1),
            jnp.zeros(len(wno)), jnp.asarray(wno), dwno=jnp.zeros(len(wno)))
        return np.asarray(disco.compress_thermal(
            f, jnp.asarray(geom.gweight), jnp.asarray(geom.tweight)))

    iso = run(tlevel)
    hot_interior = run(tlevel + np.linspace(0, 400, len(tlevel)))
    assert (hot_interior > iso).all()


def test_blackbody_integrated_matches_center_for_narrow_bins():
    wave = np.linspace(2000.0, 8000.0, 20)
    dw = np.zeros(20) + 1.0  # 1 cm^-1 bins: integral ~ center value
    T = np.array([1200.0])
    binned = np.asarray(toon.blackbody_integrated(T, wave, dw))[0]
    from picaso_tpu.constants import PLANCK_C1, PLANCK_C2
    center = PLANCK_C1 * wave ** 3 / (np.exp(PLANCK_C2 * wave / T[0]) - 1)
    np.testing.assert_allclose(binned, center, rtol=1e-5)


def test_scattering_probes_deeper():
    """Scattering lowers the effective absorption depth (tau_abs=(1-w0)tau),
    so with a hotter interior the emergent flux increases with w0."""
    wno, tlevel, plevel, dtau, w0m, cosb = _setup(dtau_total=5.0)
    tlevel = tlevel + np.linspace(0, 500, len(tlevel))
    geom = disco.make_geometry(0, num_gangle=10, num_tangle=1)

    def run(w0val):
        f, _ = toon.thermal_1d(
            jnp.asarray(tlevel), jnp.asarray(dtau),
            jnp.zeros_like(dtau) + w0val, jnp.asarray(cosb),
            jnp.asarray(plevel), jnp.asarray(geom.ubar1),
            jnp.zeros(len(wno)), jnp.asarray(wno), dwno=jnp.zeros(len(wno)))
        return np.asarray(disco.compress_thermal(
            f, jnp.asarray(geom.gweight), jnp.asarray(geom.tweight)))

    assert (run(0.7) > run(1e-6)).all()


def test_thermal_f32_pure_absorption_stable():
    """f32 thermal at w0 -> 0 (absorption-dominated wavelengths).

    gama = (g1 - lamda)/g2 cancels catastrophically when g2 -> 0: a
    1-ulp rounding of sqrt(g1^2 - g2^2) flips gama between ~0 and ~2,
    which gave thermal fluxes ~100x wrong where sqrt is not correctly
    rounded.  The stable form g2/(g1 + lamda) must keep f32 within ~1e-3
    of f64.  (CPU's correctly rounded sqrt hides the old formula's
    failure; this test pins the stable form's accuracy on any backend.)"""
    import jax
    nlayer, nwno = 30, 20
    dtau64 = np.logspace(-6, 0.5, nlayer)[:, None] * np.ones((1, nwno))
    w064 = np.full((nlayer, nwno), 1.3e-7)
    cosb64 = np.zeros((nlayer, nwno))
    tlevel64 = np.linspace(250.0, 1700.0, nlayer + 1)
    plevel64 = np.logspace(-6, 2, nlayer + 1)
    wno_v64 = np.linspace(700.0, 1500.0, nwno)
    u1 = np.full((1, 1), 0.5)   # lamda*u1 = 1 exactly at w0 = 0

    def run(dtype):
        c = lambda x: jnp.asarray(x, dtype)
        flux, _ = toon.thermal_1d(
            c(tlevel64), c(dtau64), c(w064), c(cosb64), c(plevel64),
            c(u1), c(np.zeros(nwno)), c(wno_v64), dwno=c(np.zeros(nwno)))
        return np.asarray(flux, np.float64)[0, 0]

    with jax.enable_x64(False):
        f32 = run(jnp.float32)
    f64 = run(jnp.float64)
    assert np.isfinite(f32).all()
    rel = np.abs(f32 - f64) / np.abs(f64)
    assert rel.max() < 1e-3, rel.max()
