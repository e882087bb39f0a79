"""Toon et al. (1989) two-stream radiative transfer in JAX.

Reimplements the numba hot kernels of the reference
(``/root/reference/picaso/fluxes.py``):

* ``get_reflected_1d``  (fluxes.py:1010-1413) -> :func:`reflected_1d`
* ``get_thermal_1d``    (fluxes.py:1683-1912) -> :func:`thermal_1d`
* blackbody helpers     (fluxes.py:1609-1680) -> :func:`blackbody`,
  :func:`blackbody_integrated`

Design: the reference loops serially over (gauss x chebyshev) disk angles and
then over wavelength for the tridiagonal solve.  Here a single angle's
calculation is a pure function of [nlayer, nwno] arrays; the angle axis is
``jax.vmap``-ed and wavelength is the vector-lane axis everywhere (including
inside the scan-based tridiagonal solve), so the whole disk solves in one
fused XLA program with no Python loops.  The layer recursions (TOA intensity
accumulation, thermal source-function sweeps) are ``lax.scan``s of length
nlayer with [nwno]-wide fused bodies.

Deliberate reference quirks preserved: exponent clipping at 35
(fluxes.py:1174), the tau_top fake boundary (fluxes.py:1797-1800), mu1=0.5
hemispheric mean, ubar2=0.767 Rayleigh fit (fluxes.py:1280), and the
reverse-order Thomas elimination.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..constants import PI, PLANCK_C1, PLANCK_C2
from .tridiag import solve_two_stream

__all__ = [
    'ScatteringControls', 'FluxSet', 'reflected_1d', 'thermal_1d',
    'blackbody', 'blackbody_integrated',
]

_EXP_CLIP = 35.0   # fluxes.py:1174 — overflow guard on lamda*dtau (f64)
_EXP_CLIP32 = 10.0  # f32 analog: e^10 ~ 2e4 keeps exp(+x)*exp(-x)
#                     cancellations within f32 precision; a layer with
#                     lamda*dtau > 10 transmits < 5e-5 so the physics
#                     change is negligible (the reference's 35 assumes
#                     float64 headroom)


def _exp_clip(dtype):
    return _EXP_CLIP32 if dtype == jnp.float32 else _EXP_CLIP

def _safe(den, eps=1e-6):
    """Sign-preserving clamp of the lamda*mu -> 1 resonance denominators.

    The reference divides by (lamda*ubar - 1) unprotected
    (fluxes.py:1389-1400, :1883-1907) and NaNs on exact hits; clamping
    only stops the NaN, so use it on a denominator whose ratio is also
    guarded by :func:`_resonant_ratio` (or where the numerator vanishes
    with the denominator by construction).
    """
    return jnp.where(jnp.abs(den) < eps,
                     jnp.where(den < 0, -eps, eps), den)


def _resonant_ratio(num, den, limit, eps=1e-4):
    """``num / den`` with the analytic limit substituted near ``den = 0``.

    The source-function terms divided by (lamda*mu - 1) are removable
    expm1-type singularities (fluxes.py:1389-1400, :1883-1907): the
    numerator vanishes with the denominator, so close to the resonance
    the quotient is pure f32 cancellation noise.  ``limit`` is the
    second-order Taylor expansion of the quotient, exact at den = 0.

    REJECTED alternative (round 5, kept as a warning): switching to the
    series on the UNION |x| < 0.05 OR |den| < eps, where x is the
    numerator's product-form exponent (e.g. dtau*den/mu for
    (exp(dtau*den/mu) - 1)/den, computed by multiplication so it has no
    cancellation).  On paper that bounds the scheme's relative error at
    ~5e-6 everywhere, vs up to ~3-digit loss for the quotient on
    small-|x| lanes at moderate den.  Measured, the accuracy win was
    negligible (f32-vs-f64 albedo median 4.2e-7 -> 4.0e-7) — and it
    broke the climate solver: the thermal source terms fed the fused
    Newton RCE solve values that de-synchronize from the clip-SATURATED
    two-stream system on deep layers (exptrm clipped at 10 in f32;
    G/H/J/K carry the compensating scale, so only the CLIPPED quotient
    stays consistent in the product — the reference clips both at 35,
    fluxes.py:1683-1912), and under XLA fusion the enlarged series arm
    additionally produced optimizer-dependent NaNs in the layer fluxes
    (jax_debug_nans: the de-optimized program is NaN-free).  Net effect:
    a converging 48-bin sliced-CK RCE solve collapsed to a 146 K top of
    atmosphere (caught by the multichip dryrun; regression test at
    tests/test_resonant_clip.py).  The |den|-only switch below is the
    round-4 rule that production behavior is validated against; do not
    widen it without re-running that test and the full parity suite.
    """
    return jnp.where(jnp.abs(den) < eps, limit, num / _safe(den))


def _dither_u0(lamda, u0, delta=None):
    """Elementwise beam-angle dither off the lamda*u0 = 1 resonance.

    The c+- particular solution has 1/(lamda^2 - 1/u0^2) with a
    NON-removable singularity in a_plus/a_minus individually (the finite
    physical limit only appears after cancellation, fluxes.py:1158-1169),
    so no ratio guard exists; the standard cure (cf. DISORT dithering) is
    to nudge u0 away from the eigenvalue where they collide.  Error is
    O(delta) at the isolated resonant (layer, wavelength) points only.

    delta balances dither bias O(delta) against post-cancellation noise
    O(eps_mach/delta): ~sqrt(eps) per dtype (1e-3 f32, 1e-8 f64 — the
    latter keeps f64 CPU runs within ~1e-8 of the reference's unprotected
    arithmetic near resonances).
    """
    if delta is None:
        delta = 1e-3 if jnp.asarray(lamda).dtype == jnp.float32 else 1e-8
    resonant = jnp.abs(lamda * u0 - 1.0) < delta
    return jnp.where(resonant, 1.0 / (lamda * (1.0 + delta)), u0)



@dataclasses.dataclass(frozen=True)
class ScatteringControls:
    """Static phase-function / scheme options (hashable -> jit static arg).

    Integer enums follow the reference option tables (justdoit.py:5512-5658):
    single_phase: 0=cahoy 1=OTHG 2=TTHG 3=TTHG_ray
    multi_phase:  0=N=2   1=N=1
    toon_coefficients: 0=quadrature 1=eddington
    """
    single_phase: int = 3
    multi_phase: int = 0
    toon_coefficients: int = 0
    frac_a: float = 1.0
    frac_b: float = -1.0
    frac_c: float = 2.0
    constant_back: float = -0.5
    constant_forward: float = 1.0


class FluxSet(NamedTuple):
    """Level & midpoint two-stream fluxes, each [..., nlevel, nwno]."""
    minus: jnp.ndarray
    plus: jnp.ndarray
    minus_mdpt: jnp.ndarray
    plus_mdpt: jnp.ndarray


def _reflected_coefficients(w0, ftau_cld, cosb, controls):
    """Two-stream coefficients (g1, g2, lamda, gama) of the reflected
    solve (fluxes.py:1134-1141)."""
    sq3 = jnp.sqrt(3.0).astype(w0.dtype)
    if controls.toon_coefficients == 1:  # eddington (fluxes.py:1134)
        g1 = (7.0 - w0 * (4.0 + 3.0 * ftau_cld * cosb)) / 4.0
        g2 = -(1.0 - w0 * (4.0 - 3.0 * ftau_cld * cosb)) / 4.0
    else:  # quadrature (fluxes.py:1137)
        g1 = (sq3 * 0.5) * (2.0 - w0 * (1.0 + ftau_cld * cosb))
        g2 = (sq3 * w0 * 0.5) * (1.0 - ftau_cld * cosb)
    lamda = jnp.sqrt(g1 ** 2 - g2 ** 2)
    # stable form of (g1 - lamda)/g2 (fluxes.py:1141): multiplying by
    # (g1 + lamda)/(g1 + lamda) removes the g1 - sqrt(g1^2 - g2^2)
    # cancellation that explodes at f32 when g2 -> 0 (pure absorption:
    # 1-ulp rounding of the sqrt flips gama between ~0 and ~2)
    gama = g2 / (g1 + lamda)
    return g1, g2, lamda, gama


def _beam_g3(ftau_cld, cosb, u0, controls):
    """Beam-source coefficient g3 at incidence cosine u0."""
    if controls.toon_coefficients == 1:  # eddington
        return (2.0 - 3.0 * ftau_cld * cosb * u0) / 4.0
    sq3 = jnp.sqrt(3.0).astype(cosb.dtype)
    return 0.5 * (1.0 - sq3 * ftau_cld * cosb * u0)  # quadrature


def _single_phase(controls, cosb_og, ftau_cld, ftau_ray, gcos2, cos_theta):
    """Single-scattering phase function at the phase angle
    (fluxes.py:1298-1373)."""
    sp = controls.single_phase
    if sp != 1:
        g_forward = controls.constant_forward * cosb_og
        g_back = controls.constant_back * cosb_og
        fc = float(controls.frac_c)
        g_back_pow = g_back ** (int(fc) if fc.is_integer() else fc)
        f = controls.frac_a + controls.frac_b * g_back_pow
        HG_fwd = (1 - g_forward ** 2) / jnp.sqrt(
            (1 + g_forward ** 2 + 2 * g_forward * cos_theta) ** 3)
        HG_back = (1 - g_back ** 2) / jnp.sqrt(
            (1 + g_back ** 2 + 2 * g_back * cos_theta) ** 3)
    if sp == 0:  # cahoy
        return f * HG_fwd + (1 - f) * HG_back + gcos2
    if sp == 1:  # OTHG
        return (1 - cosb_og ** 2) / jnp.sqrt(
            (1 + cosb_og ** 2 + 2 * cosb_og * cos_theta) ** 3)
    if sp == 2:  # TTHG
        return f * HG_fwd + (1 - f) * HG_back
    if sp == 3:  # TTHG_ray
        return (ftau_cld * (f * HG_fwd + (1 - f) * HG_back)
                + ftau_ray * (0.75 * (1 + cos_theta * cos_theta)))
    raise ValueError(f'unknown single_phase {sp}')


def _multi_phase(controls, ftau_cld, cosb, gcos2, u1):
    """Multiple-scattering Legendre terms (fluxes.py:1275-1287)."""
    if controls.multi_phase == 0:  # N=2
        ubar2 = 0.767
        multi_plus = (1.0 + 1.5 * ftau_cld * cosb * u1
                      + gcos2 * (3.0 * ubar2 * ubar2 * u1 * u1 - 1.0) / 2.0)
        multi_minus = (1.0 - 1.5 * ftau_cld * cosb * u1
                       + gcos2 * (3.0 * ubar2 * ubar2 * u1 * u1 - 1.0) / 2.0)
    elif controls.multi_phase == 1:  # N=1
        multi_plus = 1.0 + 1.5 * ftau_cld * cosb * u1
        multi_minus = 1.0 - 1.5 * ftau_cld * cosb * u1
    else:  # isotropic: the option the reference enumerates
        # (justdoit.py:5519) but never implemented — its branch dies
        # with UnboundLocalError (fluxes.py:1275-1287 has no case 2).
        # Zeroth-order Legendre expansion: no angular weighting.
        multi_plus = jnp.ones_like(cosb * u1)
        multi_minus = multi_plus
    return multi_plus, multi_minus


# ---------------------------------------------------------------------------
# blackbody sources
# ---------------------------------------------------------------------------

def blackbody(t, w):
    """Planck flux per unit wavelength (erg/cm^2/s/cm); t[K] x w[cm] grids.

    Port of fluxes.py:1660-1680 (same constants for bit parity).
    """
    t = jnp.atleast_1d(t)
    w = jnp.atleast_1d(w)
    return (PLANCK_C1 / w[None, :] ** 5
            / (jnp.exp(PLANCK_C2 / (t[:, None] * w[None, :])) - 1.0))


def blackbody_integrated(T, wave, dwave):
    """Bin-integrated Planck energy per wavenumber bin (erg/cm^2/s/cm^-1).

    3-point rectangle rule across each bin exactly as fluxes.py:1609-1658
    (nbb=1: center and one point on either side at +-dwave/2).
    """
    T = jnp.atleast_1d(T)
    offsets = jnp.array([-0.5, 0.0, 0.5], dtype=wave.dtype)
    wavenum = wave[None, :] + offsets[:, None] * dwave[None, :]  # [3, nwno]
    planck = PLANCK_C1 * wavenum[None, :, :] ** 3 / (
        jnp.exp(PLANCK_C2 * wavenum[None, :, :] / T[:, None, None]) - 1.0)
    return planck.sum(axis=1) / 3.0


# ---------------------------------------------------------------------------
# reflected light
# ---------------------------------------------------------------------------

def _reflected_one_angle(dtau, tau, w0, cosb, gcos2, ftau_cld, ftau_ray,
                         dtau_og, tau_og, w0_og, cosb_og,
                         g1, g2, lamda, gama,
                         exptrm, exptrm_positive, exptrm_minus, p_single,
                         u0, u1, cos_theta, F0PI, surf_reflect, b_top,
                         controls: ScatteringControls,
                         get_toa_intensity: bool, get_lvl_flux: bool):
    """Single (ubar0, ubar1) facet of fluxes.py:1143-1411.

    Angle-independent quantities (exptrm terms, the single-scattering phase
    function at the planetary phase angle) are hoisted out of the angle
    vmap by the caller — the reference recomputes them per disk angle
    (fluxes.py:1144-1177, 1298-1373)."""
    g3 = _beam_g3(ftau_cld, cosb, u0, controls)
    g4 = 1.0 - g3
    u0b = _dither_u0(lamda, u0)  # beam angle, nudged off the eigenvalue
    denominator = lamda ** 2 - 1.0 / u0b ** 2

    a_minus = F0PI * w0 * (g4 * (g1 + 1.0 / u0b) + g2 * g3) / denominator
    a_plus = F0PI * w0 * (g3 * (g1 - 1.0 / u0b) + g2 * g4) / denominator

    x_up = jnp.exp(-tau[:-1] / u0b)
    c_minus_up = a_minus * x_up
    c_plus_up = a_plus * x_up
    # beam layer transmission: tau[1:] = tau[:-1] + dtau, so the lower
    # attenuation is x_up * e_u0dt and e_u0dt is reused in the msterm
    # transmission below (one fewer exp sweep per disk angle)
    e_u0dt = jnp.exp(-dtau / u0b)
    x_dn = x_up * e_u0dt
    c_minus_down = a_minus * x_dn
    c_plus_down = a_plus * x_dn

    b_surface = 0.0 + surf_reflect * u0 * F0PI * jnp.exp(-tau[-1] / u0)

    positive, negative = solve_two_stream(
        c_plus_up, c_minus_up, c_plus_down, c_minus_down,
        b_top, b_surface, surf_reflect, gama, dtau,
        exptrm_positive, exptrm_minus)

    nlayer, nwno = dtau.shape
    nlevel = nlayer + 1

    lvl = None
    if get_lvl_flux:
        # level fluxes (fluxes.py:1219-1257)
        f_minus_top = positive * gama + negative + c_minus_up
        f_plus_top = positive + gama * negative + c_plus_up
        flux_zero_minus = (gama[-1] * positive[-1] * exptrm_positive[-1]
                           + negative[-1] * exptrm_minus[-1] + c_minus_down[-1])
        flux_zero_plus = (positive[-1] * exptrm_positive[-1]
                          + gama[-1] * negative[-1] * exptrm_minus[-1]
                          + c_plus_down[-1])
        flux_minus = jnp.concatenate([f_minus_top, flux_zero_minus[None]], 0)
        flux_plus = jnp.concatenate([f_plus_top, flux_zero_plus[None]], 0)
        flux_minus = flux_minus + u0 * F0PI * jnp.exp(-tau / u0)

        exptrm_positive_mid = jnp.exp(0.5 * exptrm)
        exptrm_minus_mid = 1.0 / exptrm_positive_mid
        taumid = tau[:-1] + 0.5 * dtau
        x_mid = jnp.exp(-taumid / u0b)
        c_plus_mid = a_plus * x_mid
        c_minus_mid = a_minus * x_mid
        fm_mid = (gama * positive * exptrm_positive_mid
                  + negative * exptrm_minus_mid + c_minus_mid)
        fp_mid = (positive * exptrm_positive_mid
                  + gama * negative * exptrm_minus_mid + c_plus_mid)
        fm_mid = fm_mid + u0 * F0PI * jnp.exp(-taumid / u0)
        zrow = jnp.zeros((1, nwno), dtau.dtype)
        lvl = FluxSet(minus=flux_minus, plus=flux_plus,
                      minus_mdpt=jnp.concatenate([fm_mid, zrow], 0),
                      plus_mdpt=jnp.concatenate([fp_mid, zrow], 0))

    xint_top = None
    if get_toa_intensity:
        flux_zero = (positive[-1] * exptrm_positive[-1]
                     + gama[-1] * negative[-1] * exptrm_minus[-1]
                     + c_plus_down[-1])
        xint_bottom = flux_zero / PI

        multi_plus, multi_minus = _multi_phase(controls, ftau_cld, cosb,
                                               gcos2, u1)

        G = positive * (multi_plus + gama * multi_minus) * w0 * (0.5 / PI)
        H = negative * (gama * multi_plus + multi_minus) * w0 * (0.5 / PI)
        A = ((multi_plus * c_plus_up + multi_minus * c_minus_up) * w0
             * (0.5 / PI))

        # layer source terms of the upward recursion (fluxes.py:1381-1407).
        # trans = exp(-dtau/u1) is reused in both resonant quotients:
        # exp(+-exptrm - dtau/u1) as exact products of already-computed
        # exponentials (two fewer exp sweeps per disk angle)
        trans = jnp.exp(-dtau / u1)
        ssterm = ((w0_og * F0PI / (4.0 * PI)) * p_single
                  * jnp.exp(-tau_og[:-1] / u0)
                  * (1.0 - jnp.exp(-dtau_og * (u0 + u1) / (u0 * u1)))
                  * (u0 / (u0 + u1)))
        den_u1 = lamda * u1 - 1.0
        hdt1 = dtau / u1
        x1 = hdt1 * den_u1   # exponent of the product form, no cancellation
        # exp(-dtau*(u0+u1)/(u0*u1)) == e_u0dt * trans (with the beam
        # angle dithered off the eigenvalue, consistent with the c+-
        # attenuations; differs only on resonant lanes at O(delta*dtau))
        msterm = (A * (1.0 - e_u0dt * trans)
                  * (u0 / (u0 + u1))
                  + G * _resonant_ratio(
                      exptrm_positive * trans - 1.0, den_u1,
                      hdt1 * (1.0 + x1 * (0.5 + x1 / 6.0)))
                  + H * (1.0 - exptrm_minus * trans)
                  / (lamda * u1 + 1.0))
        src = ssterm + msterm

        def ascend(x_below, row):
            t_i, s_i = row
            x_i = x_below * t_i + s_i
            return x_i, None

        xint_top, _ = jax.lax.scan(ascend, xint_bottom, (trans, src),
                                   reverse=True)
    return xint_top, lvl


@partial(jax.jit, static_argnames=('controls', 'get_toa_intensity',
                                   'get_lvl_flux'))
def reflected_1d(dtau, tau, w0, cosb, gcos2, ftau_cld, ftau_ray,
                 dtau_og, tau_og, w0_og, cosb_og,
                 surf_reflect, ubar0, ubar1, cos_theta, F0PI,
                 controls: ScatteringControls = ScatteringControls(),
                 b_top=0.0, get_toa_intensity: bool = True,
                 get_lvl_flux: bool = False):
    """Disk-resolved reflected-light solve; replaces fluxes.py:1010-1413.

    Array args are [nlayer(,+1), nwno]; ubar0/ubar1 are [ng, nt].
    Returns (xint_at_top [ng, nt, nwno] or None,
             FluxSet of [ng, nt, nlevel, nwno] or None).
    """
    g1, g2, lamda, gama = _reflected_coefficients(w0, ftau_cld, cosb,
                                                  controls)

    # angle-independent hoists (the reference recomputes these per angle)
    exptrm = jnp.minimum(lamda * dtau, _exp_clip(dtau.dtype))
    exptrm_positive = jnp.exp(exptrm)
    exptrm_minus = 1.0 / exptrm_positive

    p_single = _single_phase(controls, cosb_og, ftau_cld, ftau_ray, gcos2,
                             cos_theta)

    ng, nt = ubar0.shape
    u0_flat = ubar0.reshape(-1)
    u1_flat = ubar1.reshape(-1)

    def per_angle(u0, u1):
        return _reflected_one_angle(
            dtau, tau, w0, cosb, gcos2, ftau_cld, ftau_ray,
            dtau_og, tau_og, w0_og, cosb_og, g1, g2, lamda, gama,
            exptrm, exptrm_positive, exptrm_minus, p_single,
            u0, u1, cos_theta, F0PI, surf_reflect, b_top,
            controls, get_toa_intensity, get_lvl_flux)

    xint, lvl = jax.vmap(per_angle)(u0_flat, u1_flat)
    if get_toa_intensity:
        xint = xint.reshape(ng, nt, -1)
    if get_lvl_flux:
        lvl = FluxSet(*(x.reshape(ng, nt, *x.shape[1:]) for x in lvl))
    return xint, lvl


# ---------------------------------------------------------------------------
# thermal emission
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=('hard_surface', 'calc_type'))
def thermal_1d(tlevel, dtau, w0, cosb, plevel, ubar1, surf_reflect, wno,
               dwno=None, hard_surface: bool = False, calc_type: int = 0):
    """Source-function thermal emission; replaces fluxes.py:1683-1912.

    tlevel [nlevel]; dtau/w0/cosb [nlayer, nwno]; plevel [nlevel];
    ubar1 [ng, nt]; wno [nwno].  calc_type=0 -> monochromatic blackbody
    spectrum; calc_type=1 -> bin-integrated blackbody (climate), needs dwno.

    Returns (flux_at_top [ng, nt, nwno], FluxSet of [ng, nt, nlevel, nwno]).
    """
    nlayer, nwno = dtau.shape
    mu1 = 0.5  # hemispheric mean, Table 1 Toon (fluxes.py:1748)

    if calc_type == 0:
        all_b = blackbody(tlevel, 1.0 / wno)
    else:
        all_b = blackbody_integrated(tlevel, wno, dwno)
    all_b = all_b.astype(dtau.dtype)

    b0 = all_b[:-1]
    b1 = (all_b[1:] - b0) / dtau  # eqn 26 Toon89

    g1 = 2.0 - w0 * (1.0 + cosb)
    g2 = w0 * (1.0 - cosb)
    lamda = jnp.sqrt(g1 ** 2 - g2 ** 2)
    # stable form of (g1 - lamda)/g2 (fluxes.py:1141): multiplying by
    # (g1 + lamda)/(g1 + lamda) removes the g1 - sqrt(g1^2 - g2^2)
    # cancellation that explodes at f32 when g2 -> 0 (pure absorption:
    # 1-ulp rounding of the sqrt flips gama between ~0 and ~2)
    gama = g2 / (g1 + lamda)
    g1_plus_g2 = 1.0 / (g1 + g2)

    twopimu = 2.0 * PI * mu1
    c_plus_up = twopimu * (b0 + b1 * g1_plus_g2)
    c_minus_up = twopimu * (b0 - b1 * g1_plus_g2)
    c_plus_down = twopimu * (b0 + b1 * dtau + b1 * g1_plus_g2)
    c_minus_down = twopimu * (b0 + b1 * dtau - b1 * g1_plus_g2)

    exptrm = jnp.minimum(lamda * dtau, _exp_clip(dtau.dtype))
    exptrm_positive = jnp.exp(exptrm)
    exptrm_minus = 1.0 / exptrm_positive

    # fake isothermal continuation above the model top (fluxes.py:1797-1800)
    tau_top = dtau[0] * plevel[0] / (plevel[1] - plevel[0])
    b_top = (1.0 - jnp.exp(-tau_top / mu1)) * all_b[0] * PI
    if hard_surface:
        b_surface = (1.0 - surf_reflect) * all_b[-1] * PI
    else:
        b_surface = (all_b[-1] + b1[-1] * mu1) * PI

    positive, negative = solve_two_stream(
        c_plus_up, c_minus_up, c_plus_down, c_minus_down,
        b_top, b_surface, surf_reflect, gama, dtau,
        exptrm_positive, exptrm_minus)

    # source-function technique, Table 3 Toon (fluxes.py:1842-1849)
    G = (1.0 / mu1 - lamda) * positive
    H = gama * (lamda + 1.0 / mu1) * negative
    J = gama * (lamda + 1.0 / mu1) * positive
    K = (1.0 / mu1 - lamda) * negative
    alpha1 = 2.0 * PI * (b0 + b1 * (g1_plus_g2 - mu1))
    alpha2 = 2.0 * PI * b1
    sigma1 = 2.0 * PI * (b0 - b1 * (g1_plus_g2 - mu1))
    sigma2 = alpha2

    exptrm_positive_mdpt = jnp.exp(0.5 * exptrm)
    exptrm_minus_mdpt = 1.0 / exptrm_positive_mdpt

    def per_angle(iubar):
        if hard_surface:
            fplus_bottom = (1.0 - surf_reflect) * all_b[-1] * 2.0 * PI
        else:
            fplus_bottom = (all_b[-1] + b1[-1] * iubar) * 2.0 * PI
        fminus_top = (1.0 - jnp.exp(-tau_top / iubar)) * all_b[0] * 2.0 * PI

        # one exp per angle: the full-layer transmission is the square of
        # the midpoint transmission
        exptrm_angle_mdpt = jnp.exp(-0.5 * dtau / iubar)
        exptrm_angle = exptrm_angle_mdpt * exptrm_angle_mdpt

        # downward sweep (fluxes.py:1883-1893); the K terms have
        # removable lamda*ubar -> 1 singularities (see _resonant_ratio)
        den = lamda * iubar - 1.0
        hdt = dtau / iubar          # lamda*dtau at the resonance
        xden = hdt * den   # exponent of the product forms, no cancellation
        dn_full = (J / (lamda * iubar + 1.0)
                   * (exptrm_positive - exptrm_angle)
                   + K * _resonant_ratio(
                       exptrm_angle - exptrm_minus, den,
                       exptrm_minus * hdt
                       * (1.0 + xden * (0.5 + xden / 6.0)))
                   + sigma1 * (1.0 - exptrm_angle)
                   + sigma2 * (iubar * exptrm_angle + dtau - iubar))
        dn_mid = (J / (lamda * iubar + 1.0)
                  * (exptrm_positive_mdpt - exptrm_angle_mdpt)
                  + K * _resonant_ratio(
                      exptrm_minus_mdpt - exptrm_angle_mdpt, -den,
                      exptrm_angle_mdpt * 0.5 * hdt
                      * (1.0 - 0.25 * xden + xden * xden / 24.0))
                  + sigma1 * (1.0 - exptrm_angle_mdpt)
                  + sigma2 * (iubar * exptrm_angle_mdpt + 0.5 * dtau - iubar))

        def down(fm_above, row):
            t_full, t_mid, s_full, s_mid = row
            fm_mid = fm_above * t_mid + s_mid
            fm_below = fm_above * t_full + s_full
            return fm_below, (fm_below, fm_mid)

        _, (fm_levels, fm_mids) = jax.lax.scan(
            down, fminus_top,
            (exptrm_angle, exptrm_angle_mdpt, dn_full, dn_mid))
        flux_minus = jnp.concatenate([fminus_top[None], fm_levels], 0)
        flux_minus_mdpt = jnp.concatenate(
            [fm_mids, jnp.zeros((1, nwno), dtau.dtype)], 0)

        # upward sweep (fluxes.py:1897-1907)
        up_full = (G * _resonant_ratio(
                       exptrm_positive * exptrm_angle - 1.0, den,
                       hdt * (1.0 + xden * (0.5 + xden / 6.0)))
                   + H / (lamda * iubar + 1.0)
                   * (1.0 - exptrm_minus * exptrm_angle)
                   + alpha1 * (1.0 - exptrm_angle)
                   + alpha2 * (iubar - (dtau + iubar) * exptrm_angle))
        up_mid = (G * _resonant_ratio(
                      exptrm_positive * exptrm_angle_mdpt
                      - exptrm_positive_mdpt, den,
                      exptrm_positive_mdpt * 0.5 * hdt
                      * (1.0 + 0.25 * xden + xden * xden / 24.0))
                  - H / (lamda * iubar + 1.0)
                  * (exptrm_minus * exptrm_angle_mdpt - exptrm_minus_mdpt)
                  + alpha1 * (1.0 - exptrm_angle_mdpt)
                  + alpha2 * (iubar + 0.5 * dtau
                              - (dtau + iubar) * exptrm_angle_mdpt))

        def up(fp_below, row):
            t_full, t_mid, s_full, s_mid = row
            fp_mid = fp_below * t_mid + s_mid
            fp_above = fp_below * t_full + s_full
            return fp_above, (fp_above, fp_mid)

        _, (fp_levels, fp_mids) = jax.lax.scan(
            up, fplus_bottom,
            (exptrm_angle, exptrm_angle_mdpt, up_full, up_mid),
            reverse=True)
        flux_plus = jnp.concatenate([fp_levels, fplus_bottom[None]], 0)
        flux_plus_mdpt = jnp.concatenate(
            [fp_mids, jnp.zeros((1, nwno), dtau.dtype)], 0)

        flux_at_top = flux_plus_mdpt[0]
        return flux_at_top, FluxSet(flux_minus, flux_plus,
                                    flux_minus_mdpt, flux_plus_mdpt)

    ng, nt = ubar1.shape
    flux_top, lvl = jax.vmap(per_angle)(ubar1.reshape(-1))
    flux_top = flux_top.reshape(ng, nt, nwno)
    lvl = FluxSet(*(x.reshape(ng, nt, *x.shape[1:]) for x in lvl))
    return flux_top, lvl
