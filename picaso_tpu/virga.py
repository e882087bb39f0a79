"""Cloud microphysics: Ackerman & Marley (2001) eddy-sedimentation balance.

The reference delegates cloud microphysics to the external ``virga``
package (justdoit.py:4269-4533, climate update_clouds).  This module is a
self-contained equivalent of the capability surface the framework
needs from it:

* saturation vapor pressure curves for the major condensates
  (``pvaps``, literature expressions as compiled for the AM01 family of
  models: Visscher+2006/2010, Morley+2012, Wexler/AM01);
* ``condensation_t`` — condensation temperature curves;
* the AM01 balance: above the cloud base the total condensate+vapor mixing
  ratio falls as (p/p_base)^fsed, the condensed fraction is
  q_t - q_sat, and the particle size follows from equating the fall
  velocity to fsed * w* with w* = Kzz/L (mixing length);
* layer optical depth / single-scattering albedo / asymmetry from Mie
  coefficient tables (virga .mieff format) or a geometric-optics fallback
  so cloudy runs work without downloaded Mie data;
* ``Atmosphere`` + ``compute`` + ``picaso_format`` mirroring the virga API
  used by the reference call sites.
"""

from __future__ import annotations

import os

import numpy as np
import pandas as pd

from .constants import AMU, K_B
from .wavelength import get_cld_input_grid

__all__ = ['pvaps', 'condensation_t', 'recommend_gas', 'Atmosphere',
           'compute', 'picaso_format', 'available', 'load_mieff']

# condensate molecular weights (g/mol) and solid densities (g/cm^3)
GAS_PROPERTIES = {
    'H2O': (18.015, 0.93), 'CH4': (16.04, 0.49), 'NH3': (17.03, 0.84),
    'Fe': (55.85, 7.87), 'MgSiO3': (100.39, 3.19), 'Mg2SiO4': (140.69,
                                                               3.21),
    'Al2O3': (101.96, 3.95), 'Na2S': (78.05, 1.86), 'KCl': (74.55, 1.99),
    'ZnS': (97.46, 4.04), 'MnS': (87.00, 4.0), 'Cr': (52.0, 7.15),
    'NH4SH': (51.1, 1.17),
}


def available():
    return list(GAS_PROPERTIES)


class _Pvaps:
    """Saturation vapor pressures in dyne/cm^2 given T [K] (+ optional P).

    Expressions from the published compilations used by the AM01 model
    family (Visscher et al. 2006, 2010; Morley et al. 2012; Lodders 1999;
    AM01 appendix A for H2O/CH4/NH3).
    """

    @staticmethod
    def H2O(t, p=1.0, mh=1.0):
        # Buck (1981)-style liquid/ice blend, in dyne/cm^2
        t = np.asarray(t, float)
        tc = t - 273.16
        # np.where evaluates BOTH branches: for t < 32.2 K the liquid
        # exponent's denominator (240.97 + tc) crosses zero and exp
        # overflows even though only the ice branch is selected.  Clip
        # the exponents (exp(100) >> any physical pvap) so climate-
        # coupled hot/cold profiles run warning-free.
        liq = 6.112e3 * np.exp(np.clip(17.502 * tc / (240.97 + tc),
                                       -100.0, 100.0))
        ice = 6.112e3 * np.exp(np.clip(22.587 * tc / (273.86 + tc),
                                       -100.0, 100.0))
        return np.where(t > 273.16, liq, ice)

    @staticmethod
    def CH4(t, p=1.0, mh=1.0):
        # Lodders-style sublimation/vaporization fit (bar -> dyne/cm^2)
        t = np.asarray(t, float)
        tcr = 90.68
        a_solid = 10 ** (4.425070 - 453.92414 / t)
        a_liq = 10 ** (3.901408 - 437.54809 / t)
        return np.where(t < tcr, a_solid, a_liq) * 1e6 / 1.01325e0 * 1.01325

    @staticmethod
    def NH3(t, p=1.0, mh=1.0):
        t = np.asarray(t, float)
        return np.exp(-86596.0 / t ** 2 - 2161.0 / t + 10.53) * 1e6

    @staticmethod
    def Fe(t, p=1.0, mh=1.0):
        t = np.asarray(t, float)
        return 10 ** (7.23 - 20995.0 / t) * 1e6

    @staticmethod
    def MgSiO3(t, p=1.0, mh=1.0):
        t = np.asarray(t, float)
        return 10 ** (11.83 - 27250.0 / t - np.log10(mh)) * 1e6

    @staticmethod
    def Mg2SiO4(t, p=1.0, mh=1.0):
        t = np.asarray(t, float)
        p_bar = np.asarray(p, float)
        return 10 ** (-32488.0 / t + 14.88 - 0.2 * np.log10(p_bar)
                      - 1.4 * np.log10(mh)) * 1e6

    @staticmethod
    def Al2O3(t, p=1.0, mh=1.0):
        t = np.asarray(t, float)
        return 10 ** (17.7 - 45892.6 / t - 1.66 * np.log10(mh)) * 1e6

    @staticmethod
    def Na2S(t, p=1.0, mh=1.0):
        t = np.asarray(t, float)
        return 10 ** (8.55 - 13889.0 / t - 0.5 * np.log10(mh)) * 1e6

    @staticmethod
    def KCl(t, p=1.0, mh=1.0):
        t = np.asarray(t, float)
        return 10 ** (7.611 - 11382.0 / t) * 1e6

    @staticmethod
    def ZnS(t, p=1.0, mh=1.0):
        t = np.asarray(t, float)
        return 10 ** (12.812 - 15873.0 / t - np.log10(mh)) * 1e6

    @staticmethod
    def MnS(t, p=1.0, mh=1.0):
        t = np.asarray(t, float)
        return 10 ** (11.532 - 23810.0 / t - np.log10(mh)) * 1e6

    @staticmethod
    def Cr(t, p=1.0, mh=1.0):
        t = np.asarray(t, float)
        return 10 ** (7.49 - 20592.0 / t) * 1e6

    @staticmethod
    def NH4SH(t, p=1.0, mh=1.0):
        t = np.asarray(t, float)
        return 10 ** (14.82 - 4705.0 / t) * 1e6 / 1e6 * 1e6


pvaps = _Pvaps()


def condensation_t(species, mh, mmw, pressure=None):
    """Condensation temperature curve T_cond(P) where pvap = partial P.

    Mirrors virga.condensation_t used at justdoit.py:2208.
    """
    pressure = (np.asarray(pressure, float) if pressure is not None
                else np.logspace(-6, 2, 50))
    gas_mw, _ = GAS_PROPERTIES[species]
    # solar-ish deep abundances scaled by mh (mass mixing ratio -> partial p)
    q_deep = _deep_abundance(species, mh)
    get_pvap = getattr(pvaps, species)
    t_grid = np.linspace(10.0, 4000.0, 4000)
    out_t = np.zeros_like(pressure)
    for i, p in enumerate(pressure):
        partial = q_deep * (gas_mw / mmw) ** 0 * p * 1e6
        pv = get_pvap(t_grid, p=p, mh=mh)
        idx = np.where(pv >= partial)[0]
        out_t[i] = t_grid[idx[0]] if len(idx) else t_grid[-1]
    return pressure, out_t


def _deep_abundance(species, mh=1.0):
    """Deep volume mixing ratio of the condensing vapor (solar, x mh)."""
    base = {'H2O': 1.1e-3, 'CH4': 5.5e-4, 'NH3': 1.4e-4, 'Fe': 5.8e-5,
            'MgSiO3': 5.9e-5, 'Mg2SiO4': 5.9e-5, 'Al2O3': 4.7e-6,
            'Na2S': 3.3e-6, 'KCl': 2.2e-7, 'ZnS': 7.4e-8, 'MnS': 5.5e-7,
            'Cr': 8.8e-7, 'NH4SH': 1.4e-4}
    return base[species] * mh


def recommend_gas(pressure, temperature, mh=1.0, mmw=2.2):
    """Condensates whose condensation curve crosses the profile."""
    out = []
    for gas in GAS_PROPERTIES:
        _, tc = condensation_t(gas, mh, mmw, pressure=pressure)
        if np.any(np.asarray(temperature) < tc):
            out.append(gas)
    return out


def load_mieff(filename):
    """Read a virga .mieff Mie table.

    Format: first line 'nwave nradii'; then per radius: a line with the
    radius [cm], then nwave rows of (wave_um, qscat, qext, cos_qscat).
    Returns dict(wave_um [nw], radii [nr], qscat [nr, nw], qext, cos_qscat).
    """
    with open(filename) as f:
        tokens = f.read().split()
    nwave = int(float(tokens[0]))
    nrad = int(float(tokens[1]))
    i = 2
    radii = np.zeros(nrad)
    wave = None
    qscat = np.zeros((nrad, nwave))
    qext = np.zeros((nrad, nwave))
    cosq = np.zeros((nrad, nwave))
    for ir in range(nrad):
        radii[ir] = float(tokens[i])
        i += 1
        block = np.array(tokens[i:i + 4 * nwave], float).reshape(nwave, 4)
        i += 4 * nwave
        if wave is None:
            wave = block[:, 0]
        qscat[ir] = block[:, 1]
        qext[ir] = block[:, 2]
        cosq[ir] = block[:, 3]
    return dict(wave_um=wave, radii=radii, qscat=qscat, qext=qext,
                cos_qscat=cosq)


def _mie_at(mie, r_eff, wave_um):
    """Interpolate Mie efficiencies at particle radius + wavelengths."""
    if mie is None:
        # geometric-optics fallback with a crude size-parameter rolloff
        x = 2 * np.pi * (r_eff * 1e4) / wave_um   # r in um / wave in um
        small = x < 1
        qext = np.where(small, 2.0 * x ** 2, 2.0)
        qscat = 0.9 * qext
        cosq = np.where(small, 0.1, 0.8)
        return qext, qscat, cosq
    ir = np.clip(np.searchsorted(mie['radii'], r_eff), 0,
                 len(mie['radii']) - 1)
    qe = np.interp(wave_um, mie['wave_um'], mie['qext'][ir])
    qs = np.interp(wave_um, mie['wave_um'], mie['qscat'][ir])
    # .mieff stores the product g * qscat in the last column
    cq = np.interp(wave_um, mie['wave_um'], mie['cos_qscat'][ir])
    g = np.clip(cq / np.maximum(qs, 1e-30), -1, 1)
    return qe, qs, g


# ---------------------------------------------------------------------------
# fall velocity + particle-size machinery (AM01 appendix B)
# ---------------------------------------------------------------------------

R_GAS = 8.3143e7          # erg/mol/K
AVOG = 6.02e23
D_MOLECULE = 2.827e-8     # cm, effective H2 diameter (Rosner 2000)
EPS_K = 59.7              # K, Lennard-Jones well depth of H2


def _viscosity(t):
    """Dynamic viscosity of H2 [poise], Rosner (2000) kinetic theory.

    visc = (5/16) sqrt(pi k T m) / (pi d^2) / 1.22 (T/eps_k)^-0.16 —
    the expression the AM01/eddysed family uses.
    """
    t = np.asarray(t, float)
    m = 2.2 / AVOG * 1.0   # g per molecule (H2-dominated)
    kb = 1.38054e-16
    return (5.0 / 16.0 * np.sqrt(np.pi * kb * t * m)
            / (np.pi * D_MOLECULE ** 2)
            / (1.22 * (t / EPS_K) ** (-0.16)))


def _mean_free_path(t, p_dyne, mw_atmos):
    """Molecular mean free path [cm]."""
    rho = p_dyne * mw_atmos / (R_GAS * t)
    m = mw_atmos / AVOG
    return m / (np.sqrt(2.0) * np.pi * D_MOLECULE ** 2 * rho)


def vfall(r, grav, mw_atmos, t, p_dyne, rho_p):
    """Particle fall velocity [cm/s] at radius r [cm] (AM01 appendix B).

    Three regimes, all vectorized: Stokes flow with the Cunningham slip
    correction beta = 1 + 1.26 Kn; a Reynolds-number drag correction
    ln Re' = b1 x + b2 x^2 (x = ln Re_Stokes) for 1 < Re < 1000; and the
    fully turbulent limit v = beta sqrt(8 drho g r / (3 C_d rho)) with
    C_d = 0.45 above Re ~ 1000.  Mirrors the virga/eddysed ``vfall``
    root function the reference relies on via virga-exo
    (justdoit.py:4379-4395 -> vj.compute).
    """
    b1, b2, cdrag = 0.8, -0.01, 0.45
    r = np.asarray(r, float)
    rho_atm = p_dyne * mw_atmos / (R_GAS * t)
    visc = _viscosity(t)
    mfp = _mean_free_path(t, p_dyne, mw_atmos)
    knudsen = mfp / r
    slip = 1.0 + 1.26 * knudsen
    v_stokes = slip * (2.0 / 9.0) * (rho_p - rho_atm) * grav * r ** 2 / visc
    re_stokes = 2.0 * r * rho_atm * v_stokes / visc

    x = np.log(np.maximum(re_stokes, 1e-30))
    re_corr = np.exp(b1 * x + b2 * x ** 2)
    v_mid = visc * re_corr / (2.0 * r * rho_atm)
    v_turb = slip * np.sqrt(8.0 * (rho_p - rho_atm) * grav * r
                            / (3.0 * cdrag * rho_atm))
    v = np.where(re_stokes > 1.0, v_mid, v_stokes)
    return np.where(re_corr > 1e3, v_turb, v)


def _solve_rw(w_convect, grav, mw_atmos, t, p_dyne, rho_p,
              lo=1e-10, hi=10.0, n_bisect=60):
    """Radius r_w with vfall(r_w) = w_convect, by vectorized bisection.

    vfall is monotone increasing in r over the physical range, so
    bisection on log r converges unconditionally (virga uses scalar
    brentq per layer; here all layers solve in one vectorized sweep).
    """
    llo = np.zeros_like(np.asarray(w_convect, float)) + np.log(lo)
    lhi = np.zeros_like(llo) + np.log(hi)
    for _ in range(n_bisect):
        mid = 0.5 * (llo + lhi)
        v = vfall(np.exp(mid), grav, mw_atmos, t, p_dyne, rho_p)
        too_slow = v < w_convect
        llo = np.where(too_slow, mid, llo)
        lhi = np.where(too_slow, lhi, mid)
    return np.exp(0.5 * (llo + lhi))


def _vfall_alpha(rw, w_convect, grav, mw_atmos, t, p_dyne, rho_p):
    """Local power-law exponent alpha of vfall ~ r^alpha near r_w
    (AM01 eq 13 fit; virga fits over [rw, rw*1.1])."""
    v_up = vfall(rw * 1.1, grav, mw_atmos, t, p_dyne, rho_p)
    return np.log(np.maximum(v_up, 1e-30) / np.maximum(w_convect, 1e-30)) \
        / np.log(1.1)


def get_r_grid(r_min=1e-10, n_radii=60):
    """Log-spaced particle-radius grid with eddysed bin widths.

    Volume ratio vrat=2.2 between bins (radius ratio vrat^(1/3)), bin
    width dr = r (f2 - f1) with f1/f2 the half-bin volume offsets —
    the grid virga builds when no .mieff table fixes one.
    """
    vrat = 2.2
    pw = 1.0 / 3.0
    f1 = (2.0 / (1.0 + vrat)) ** pw
    f2 = (2.0 * vrat / (1.0 + vrat)) ** pw
    radius = r_min * vrat ** (np.arange(n_radii) * pw)
    dr = radius * (f2 - f1)
    return radius, dr


class Atmosphere:
    """virga-style driver object (vj.Atmosphere(...).compute analog).

    Reference call pattern (justdoit.py:4379-4395): construct with the
    condensate list + microphysics knobs, set gravity, call ``ptk`` with
    a pressure/temperature/kz dataframe, then :func:`compute`.

    ``param`` selects the sedimentation-efficiency profile: 'const'
    (fsed constant) or 'exp' (fsed(z) = (fsed - eps) exp((z -
    z_alpha)/beta) + eps, the Rooney+2022 variable-fsed form virga 2.0
    implements; z_alpha set by ``alpha_pressure`` in :meth:`ptk`, and
    beta = b * H(z_alpha) with ``b`` in SCALE HEIGHTS, so b ~ O(1)).
    """

    def __init__(self, condensates, fsed=1.0, mh=1.0, mmw=2.2, sig=2.0,
                 b=1.0, eps=1e-2, param='const', supsat=0, gas_mmr=None,
                 verbose=False, **ignored):
        self.condensates = list(np.atleast_1d(condensates))
        self.fsed = fsed
        self.b = b
        self.eps = eps
        self.param = param
        self.supsat = supsat
        self.gas_mmr = dict(gas_mmr or {})
        self.mh = mh
        self.mmw = mmw
        self.sig = sig
        self.kz = None
        self.gravity = None
        self.verbose = verbose
        if param not in ('const', 'exp'):
            raise ValueError(f"param='{param}' not supported "
                             "(use 'const' or 'exp')")

    def set_gravity(self, gravity=None, gravity_unit=None):
        """Reference vj.Atmosphere.gravity(...); cgs if no unit given."""
        from . import units as u
        self.gravity = (u.to_cgs(gravity, gravity_unit) if gravity_unit
                        else float(gravity))

    gravity_ = set_gravity   # round-2 alias

    def ptk(self, df=None, kz_min=1e5, Teff=None, alpha_pressure=None,
            latent_heat=False):
        """Load the P/T/kz structure and derive layer quantities.

        Mirrors virga Atmosphere.ptk: kz floor at ``kz_min``; altitude
        from hydrostatic integration; mixing length mixl = max(0.1,
        lapse ratio) * H (AM01 eq 5 family); convective velocity
        w* = kz/mixl.  ``alpha_pressure`` anchors z_alpha for the
        variable-fsed 'exp' profile (defaults to the top of the grid).
        """
        self.pressure = np.asarray(df['pressure'], float)   # bar
        self.temperature = np.asarray(df['temperature'], float)
        kz = np.asarray(df.get('kz', np.zeros_like(self.pressure) + 1e9),
                        float)
        self.kz = np.maximum(kz, kz_min)

        p, t = self.pressure, self.temperature
        self.p_level_dyne = p * 1e6
        self.t_layer = 0.5 * (t[1:] + t[:-1])
        self.p_layer = np.sqrt(p[1:] * p[:-1])              # bar
        self.kz_layer = 0.5 * (self.kz[1:] + self.kz[:-1])
        mmw_g = self.mmw / AVOG

        # hydrostatic altitude (z=0 at the bottom level), level -> layer
        h_level = R_GAS * t / (self.mmw * self.gravity)
        dlnp = np.log(p[1:] / p[:-1])
        h_layer = R_GAS * self.t_layer / (self.mmw * self.gravity)
        dz = h_layer * dlnp                                  # >0, cm
        z = np.zeros_like(p)
        z[:-1] = np.cumsum(dz[::-1])[::-1]                   # level alt
        self.z_level = z
        self.z_layer = 0.5 * (z[1:] + z[:-1])
        self.dz_layer = dz
        self.scale_h = h_layer

        # mixing length from the local lapse ratio (AM01 sec 2)
        dtdlnp = np.diff(t) / dlnp
        lapse_ratio = np.clip(dtdlnp / ((2.0 / 7.0) * self.t_layer),
                              0.0, 1.0)
        self.mixl = np.maximum(0.1, lapse_ratio) * h_layer
        self.dtdlnp = dtdlnp

        self.w_convect = self.kz_layer / self.mixl
        self.rho_atm = (self.p_layer * 1e6 * self.mmw
                        / (R_GAS * self.t_layer))            # g/cm^3
        del mmw_g

        if alpha_pressure is None:
            self.z_alpha = z[0]                              # top of grid
        else:
            self.z_alpha = np.interp(np.log(alpha_pressure), np.log(p), z)
        # variable-fsed length scale: the constructor's b is in SCALE
        # HEIGHTS (the virga-user convention, Rooney+2022 beta = b*H);
        # convert to cm at the anchor level
        h_asc = np.interp(self.z_alpha, z[::-1], h_level[::-1])
        self.b_cm = float(self.b) * float(h_asc)
        if latent_heat and self.verbose:
            import warnings
            warnings.warn('latent_heat=True is accepted for API parity '
                          'but the latent-heat kz correction is not '
                          'implemented')

    # -- sedimentation-efficiency profile -----------------------------------
    def fsed_at(self, z):
        """fsed(z) = (fsed - eps) exp((z - z_alpha)/beta) + eps with
        beta = b * H(z_alpha) — ``b`` in scale heights (Rooney+2022)."""
        if self.param == 'const':
            return np.zeros_like(np.asarray(z, float)) + self.fsed
        arg = np.clip((np.asarray(z, float) - self.z_alpha) / self.b_cm,
                      -80.0, 80.0)
        return (self.fsed - self.eps) * np.exp(arg) + self.eps

    def fsed_integral(self, z_bot, z_top):
        """integral of fsed dz over [z_bot, z_top] (exact, both params)."""
        if self.param == 'const':
            return self.fsed * (z_top - z_bot)
        a_top = np.clip((z_top - self.z_alpha) / self.b_cm, -80.0, 80.0)
        a_bot = np.clip((z_bot - self.z_alpha) / self.b_cm, -80.0, 80.0)
        return ((self.fsed - self.eps) * self.b_cm
                * (np.exp(a_top) - np.exp(a_bot))
                + self.eps * (z_top - z_bot))


# ---------------------------------------------------------------------------
# the eddysed solve
# ---------------------------------------------------------------------------

def _calc_qc(atmo, gas, q_below, t_sub, p_sub_dyne, z_bot, z_top, mixl,
             rho_p, gas_mw):
    """qt/qc + particle sizes over one (sub)layer (virga calc_qc).

    Integrates dq_t/dz = -fsed(z) q_c / L analytically with q_vs frozen
    over the sublayer: q_t = q_vs + (q_below - q_vs) exp(-I/L) with
    I = integral of fsed dz.  Returns (qc, qt, rg, reff, ndz_per_cm).
    """
    get_pvap = getattr(pvaps, gas)
    pvap = get_pvap(t_sub, p=p_sub_dyne / 1e6, mh=atmo.mh)
    qvs = ((atmo.supsat + 1.0) * pvap / p_sub_dyne) * gas_mw / atmo.mmw

    if q_below <= qvs:        # hole in the cloud: everything stays vapor
        return 0.0, q_below, 0.0, 0.0, 0.0

    integral = atmo.fsed_integral(z_bot, z_top)
    qt = qvs + (q_below - qvs) * np.exp(-integral / mixl)
    qc = max(qt - qvs, 0.0)
    return qc, qt, None, None, None


def _finish_sizes(atmo, qc, t_layer, p_layer_dyne, z_layer, mixl, kz,
                  rho_p, dz):
    """Particle sizes for a layer with condensate (AM01 eqs 13, 17)."""
    w_convect = kz / mixl
    rw = _solve_rw(w_convect, atmo.gravity, atmo.mmw, t_layer,
                   p_layer_dyne, rho_p)
    alpha = np.maximum(_vfall_alpha(rw, w_convect, atmo.gravity, atmo.mmw,
                                    t_layer, p_layer_dyne, rho_p), 0.1)
    fsed_loc = atmo.fsed_at(z_layer)
    ln2 = 0.5 * np.log(atmo.sig) ** 2     # = ln^2(sig)/2
    rg = fsed_loc ** (1.0 / alpha) * rw * np.exp(-(alpha + 6.0) * ln2)
    reff = rg * np.exp(5.0 * ln2)
    rho_atm = p_layer_dyne * atmo.mmw / (R_GAS * t_layer)
    ndz = (3.0 * rho_atm * qc * dz
           / (4.0 * np.pi * rho_p * np.maximum(rg, 1e-30) ** 3)
           * np.exp(-9.0 * ln2))
    return rg, reff, ndz


def _layer(atmo, gas, q_below, ilay, rho_p, gas_mw, max_nsub=64, rtol=1e-2):
    """One model layer of the eddysed march (virga ``layer``): integrate
    the qt balance bottom-to-top with sublayer refinement until the
    layer condensate column converges."""
    p_bot = atmo.p_level_dyne[ilay + 1]
    p_top = atmo.p_level_dyne[ilay]
    t_bot = atmo.temperature[ilay + 1]
    dtdlnp = atmo.dtdlnp[ilay]
    z_bot = atmo.z_level[ilay + 1]
    mixl = atmo.mixl[ilay]
    grav = atmo.gravity

    prev_col = None
    nsub = 1
    while True:
        dp = (p_bot - p_top) / nsub
        qc_col = 0.0          # condensate column, g/cm^2
        qt_col = 0.0
        q_here = q_below
        p_b = p_bot
        z_b = z_bot
        for _ in range(nsub):
            p_t = p_b - dp
            p_mid = 0.5 * (p_b + p_t)
            # dtdlnp = dT/dlnP > 0 when hotter below, so going UP from
            # the layer bottom (p_mid < p_bot) must cool: ln(p_mid/p_bot)<0
            t_mid = t_bot + np.log(p_mid / p_bot) * dtdlnp
            h_mid = R_GAS * t_mid / (atmo.mmw * grav)
            dz_sub = h_mid * np.log(p_b / p_t)
            z_t = z_b + dz_sub
            qc_s, qt_s, _, _, _ = _calc_qc(atmo, gas, q_here, t_mid, p_mid,
                                           z_b, z_t, mixl, rho_p, gas_mw)
            qc_col += qc_s * dp / grav
            qt_col += qt_s * dp / grav
            q_here = qt_s
            p_b, z_b = p_t, z_t
        if prev_col is not None and (
                qc_col == 0.0
                or abs(qc_col - prev_col) <= rtol * abs(prev_col)):
            break
        if nsub >= max_nsub:
            break
        prev_col = qc_col
        nsub *= 2

    dp_layer = p_bot - p_top
    qc_layer = qc_col * grav / dp_layer        # layer-mean mmr
    qt_layer = qt_col * grav / dp_layer
    q_above = q_here                            # qt at the layer top
    return qc_layer, qt_layer, q_above


def _virtual_base(atmo, gas, q_deep, rho_p, gas_mw):
    """Cloud base below the grid (virga do_virtual): if the deepest
    level is already supersaturated, integrate a virtual layer from the
    condensation pressure up to the model bottom and return the
    (depleted) qt entering the grid."""
    get_pvap = getattr(pvaps, gas)
    p_bot = atmo.p_level_dyne[-1]
    t_bot = atmo.temperature[-1]
    dtdlnp = atmo.dtdlnp[-1]

    def qvs_at(p_dyne):
        t = t_bot + np.log(p_dyne / p_bot) * dtdlnp
        pv = get_pvap(t, p=p_dyne / 1e6, mh=atmo.mh)
        return (atmo.supsat + 1.0) * pv / p_dyne * gas_mw / atmo.mmw

    if q_deep <= qvs_at(p_bot):
        return q_deep                        # base inside/above the grid
    # bisect for the condensation pressure below the grid (up to 1000 bar
    # deeper); if none found the cloud base is effectively at infinity
    lo, hi = np.log(p_bot), np.log(p_bot * 1e3)
    if q_deep > qvs_at(np.exp(hi)):
        return q_deep
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if q_deep > qvs_at(np.exp(mid)):
            lo = mid
        else:
            hi = mid
    p_base = np.exp(0.5 * (lo + hi))
    # integrate one virtual layer from p_base to p_bot
    mixl = atmo.mixl[-1]
    t_base = t_bot + np.log(p_base / p_bot) * dtdlnp
    h = R_GAS * 0.5 * (t_base + t_bot) / (atmo.mmw * atmo.gravity)
    dz = h * np.log(p_base / p_bot)
    _, qt, _, _, _ = _calc_qc(atmo, gas, q_deep,
                              0.5 * (t_base + t_bot),
                              np.sqrt(p_base * p_bot),
                              -dz, 0.0, mixl, rho_p, gas_mw)
    return qt


def _calc_optics(wave_um, radii, dr, qext_t, qscat_t, cosq_t, qc, rg,
                 ndz, sig, rho_p, colden, reff):
    """Lognormal size-distribution optics for one gas (virga calc_optics).

    qext_t/qscat_t/cosq_t: [nrad, nwave] efficiency tables on ``radii``;
    cosq_t stores g*qscat as in the .mieff format.  Returns per-layer
    (ext, scat, cos) opacity sums [nlayer, nwave].
    """
    nlayer = len(qc)
    nwave = len(wave_um)
    ext = np.zeros((nlayer, nwave))
    scat = np.zeros((nlayer, nwave))
    cosb = np.zeros((nlayer, nwave))
    lnsig = np.log(sig)
    arg1 = dr / (np.sqrt(2.0 * np.pi) * radii * lnsig)   # [nrad]
    with np.errstate(divide='ignore', invalid='ignore'):
        for i in range(nlayer):
            if ndz[i] <= 0 or rg[i] <= 0:
                continue
            arg2 = np.exp(-np.log(radii / rg[i]) ** 2 / (2.0 * lnsig ** 2))
            pir2ndz = ndz[i] * np.pi * radii ** 2 * arg1 * arg2   # [nrad]
            ext[i] = qext_t.T @ pir2ndz
            scat[i] = qscat_t.T @ pir2ndz
            cosb[i] = cosq_t.T @ pir2ndz
    return ext, scat, cosb


def calc_optics_user_r_dist(wave_um, ndz, radii, dist, qext_t, qscat_t,
                            cosq_t):
    """Column optics for a user-supplied particle-size distribution.

    Parity role of virga's ``calc_optics_user_r_dist`` (used by the
    reference's retrieval cloud parameterizations,
    parameterizations.py:137-196): integrate the Mie efficiency tables
    against an arbitrary number-density distribution ``dist`` on the
    ``radii`` grid [cm], for a column number density ``ndz`` [cm^-2].

    qext_t/qscat_t/cosq_t: [nrad, nwave] tables (cosq_t stores the
    product g*qscat, the .mieff convention).  Returns (opd [nw], w0 [nw],
    g0 [nw], wavenumber [nw]).
    """
    wave_um = np.asarray(wave_um, float)
    radii = np.asarray(radii, float)
    dist = np.asarray(dist, float)
    dr = np.gradient(radii)
    w = dist * dr
    tot = w.sum()
    if tot <= 0:
        nw = len(wave_um)
        return np.zeros(nw), np.zeros(nw), np.zeros(nw), 1e4 / wave_um
    pir2n = ndz * np.pi * radii ** 2 * (w / tot)      # [nrad]
    ext = qext_t.T @ pir2n
    scat = qscat_t.T @ pir2n
    cosb = cosq_t.T @ pir2n
    w0 = np.clip(scat / np.maximum(ext, 1e-300), 0.0, 1.0)
    g0 = np.clip(cosb / np.maximum(scat, 1e-300), -1.0, 1.0)
    return ext, w0, g0, 1e4 / wave_um


def _q_tables(mie, radii, wave_um):
    """Efficiency tables on (radii, wave) — from a .mieff file or the
    geometric-optics fallback."""
    if mie is not None:
        return (mie['qext'], mie['qscat'], mie['cos_qscat'],
                mie['radii'],
                mie['radii'] * ((2.0 * 2.2 / 3.2) ** (1 / 3)
                                - (2.0 / 3.2) ** (1 / 3)),
                mie['wave_um'])
    x = 2.0 * np.pi * (radii[:, None] * 1e4) / wave_um[None, :]
    small = x < 1
    qext = np.where(small, 2.0 * x ** 2, 2.0)
    qscat = 0.9 * qext
    cosq = np.where(small, 0.1, 0.8) * qscat
    dr = radii * ((2.0 * 2.2 / 3.2) ** (1 / 3) - (2.0 / 3.2) ** (1 / 3))
    return qext, qscat, cosq, radii, dr, wave_um


def compute(atmo: Atmosphere, directory=None, as_dict=True,
            do_virtual=False, solver='eddysed'):
    """Cloud profile from the AM01 eddy-sedimentation balance.

    ``solver='eddysed'`` (default) runs the full virga-equivalent
    algorithm: bottom-up qt transport with sublayer refinement
    (``_layer``), fall-velocity root solve for r_w with slip + turbulent
    drag (``vfall``), AM01 eq-13 lognormal size closure, and
    size-distribution-integrated optics (``_calc_optics``), with
    variable fsed ('exp' param) and the below-grid virtual cloud
    (``do_virtual``).  ``solver='analytic'`` keeps the fast round-2
    closed-form balance (coarser: no sublayer ODE, Stokes-only sizes).

    Returns the virga-format dict: opd_per_layer / single_scattering /
    asymmetry on [nlayer, nwave] plus profile diagnostics.
    Reference pathway: justdoit.py:4379-4395, climate.py:2842-2925.
    """
    if solver == 'analytic':
        return _compute_analytic(atmo, directory=directory)

    p = atmo.pressure
    nlayer = len(p) - 1
    grav = atmo.gravity
    colden = np.diff(p * 1e6) / grav
    p_layer_dyne = atmo.p_layer * 1e6

    base_radii, base_dr = get_r_grid()
    # ONE common wave grid for every condensate: the first .mieff
    # table's if any gas has one, else the 196-pt EGP grid; per-gas
    # tables on a different grid are interpolated onto it so the
    # ext/scat/cos sums never mix grids
    mies = {gas: _load_gas_mieff(gas, directory)
            for gas in atmo.condensates}
    wave_um = next((m['wave_um'] for m in mies.values() if m is not None),
                   None)
    if wave_um is None:
        wave_um = 1e4 / get_cld_input_grid()[::-1]
    gas_tables = {}
    for gas in atmo.condensates:
        tabs = _q_tables(mies[gas], base_radii, wave_um)
        if tabs[5].shape != wave_um.shape or not np.allclose(tabs[5],
                                                             wave_um):
            order = np.argsort(tabs[5])
            src = tabs[5][order]
            tabs = tuple(
                np.stack([np.interp(wave_um, src, t[i][order])
                          for i in range(t.shape[0])])
                for t in tabs[:3]) + tabs[3:5] + (wave_um,)
        gas_tables[gas] = tabs
    nwave = len(wave_um)

    ext_tot = np.zeros((nlayer, nwave))
    scat_tot = np.zeros((nlayer, nwave))
    cos_tot = np.zeros((nlayer, nwave))
    out_cond = {}

    for gas in atmo.condensates:
        gas_mw, rho_p = GAS_PROPERTIES[gas]
        if gas in atmo.gas_mmr:
            q_deep = atmo.gas_mmr[gas]
        else:
            q_deep = _deep_abundance(gas, atmo.mh) * gas_mw / atmo.mmw
        q_below = q_deep
        if do_virtual:
            q_below = _virtual_base(atmo, gas, q_deep, rho_p, gas_mw)

        qc = np.zeros(nlayer)
        qt = np.zeros(nlayer)
        # march bottom (ilay = nlayer-1) to top
        for ilay in range(nlayer - 1, -1, -1):
            qc_l, qt_l, q_below = _layer(atmo, gas, q_below, ilay, rho_p,
                                         gas_mw)
            qc[ilay], qt[ilay] = qc_l, qt_l

        has_cld = qc > 0
        rg = np.zeros(nlayer)
        reff = np.zeros(nlayer)
        ndz = np.zeros(nlayer)
        if has_cld.any():
            rg_c, reff_c, ndz_c = _finish_sizes(
                atmo, qc, atmo.t_layer, p_layer_dyne, atmo.z_layer,
                atmo.mixl, atmo.kz_layer, rho_p, atmo.dz_layer)
            rg = np.where(has_cld, rg_c, 0.0)
            reff = np.where(has_cld, reff_c, 0.0)
            ndz = np.where(has_cld, ndz_c, 0.0)

        qext_t, qscat_t, cosq_t, radii, dr, _ = gas_tables[gas]
        ext, scat, cosb = _calc_optics(wave_um, radii, dr, qext_t, qscat_t,
                                       cosq_t, qc, rg, ndz, atmo.sig,
                                       rho_p, colden, reff)
        ext_tot += ext
        scat_tot += scat
        cos_tot += cosb
        out_cond[gas] = dict(q_c=qc, q_t=qt, r_g=rg, r_eff=reff, ndz=ndz)

    with np.errstate(divide='ignore', invalid='ignore'):
        w0n = np.where(ext_tot > 0, scat_tot / ext_tot, 0.0)
        g0n = np.where(scat_tot > 0, cos_tot / scat_tot, 0.0)
    # ascending-wavenumber orientation to match the .cld layout
    opd = ext_tot[:, ::-1]
    w0n = w0n[:, ::-1]
    g0n = g0n[:, ::-1]

    return {'opd_per_layer': opd, 'single_scattering': w0n,
            'asymmetry': g0n, 'wave': wave_um[::-1],
            'pressure': atmo.p_layer, 'temperature': atmo.t_layer,
            'condensibles': out_cond,
            'mean_particle_r': {g: out_cond[g]['r_eff']
                                for g in out_cond},
            'scalar_inputs': {'fsed': atmo.fsed, 'mh': atmo.mh,
                              'sig': atmo.sig, 'mmw': atmo.mmw,
                              'param': atmo.param, 'b': atmo.b,
                              'eps': atmo.eps}}


def _compute_analytic(atmo: Atmosphere, directory=None):
    """Round-2 closed-form AM01 balance (fast mode; see compute)."""
    wno_grid = get_cld_input_grid()
    wave_um = 1e4 / wno_grid[::-1]
    p = atmo.pressure
    t = atmo.temperature
    nlevel = len(p)
    nlayer = nlevel - 1
    grav = atmo.gravity
    mmw_g = atmo.mmw * AMU

    p_layer = np.sqrt(p[1:] * p[:-1])
    t_layer = 0.5 * (t[1:] + t[:-1])
    kz_layer = 0.5 * (atmo.kz[1:] + atmo.kz[:-1])
    scale_h = K_B * t_layer / (mmw_g * grav)              # cm
    rho_atm = p_layer * 1e6 * mmw_g / (K_B * t_layer)     # g/cm^3
    colden = np.diff(p * 1e6) / grav                      # g/cm^2

    opd = np.zeros((nlayer, len(wno_grid)))
    w0n = np.zeros_like(opd)
    g0n = np.zeros_like(opd)
    out_cond = {}

    fsed_arr = np.zeros(nlayer) + atmo.fsed
    for gas in atmo.condensates:
        gas_mw, rho_c = GAS_PROPERTIES[gas]
        get_pvap = getattr(pvaps, gas)
        q_deep = _deep_abundance(gas, atmo.mh) * gas_mw / atmo.mmw  # mass
        qsat = (get_pvap(t_layer, p=p_layer, mh=atmo.mh)
                / (p_layer * 1e6)) * gas_mw / atmo.mmw

        # find cloud base: deepest layer where q_deep exceeds saturation
        supersat = q_deep > qsat
        if not supersat.any():
            continue
        ibase = int(np.max(np.where(supersat)[0]))

        q_t = np.zeros(nlayer)
        q_c = np.zeros(nlayer)
        q_t[ibase:] = q_deep
        for i in range(ibase - 1, -1, -1):
            # AM01 eq 7: total mixing ratio falls as (p/p_base)^fsed
            q_t[i] = np.minimum(
                q_t[i + 1] * (p_layer[i] / p_layer[i + 1])
                ** fsed_arr[i], q_deep)
            q_c[i] = np.maximum(q_t[i] - qsat[i], 0.0)
        q_c[ibase] = np.maximum(q_deep - qsat[ibase], 0.0)

        # particle size from v_fall(r_w) = fsed w* (AM01 eq 4-6); Stokes
        # with dynamic viscosity of H2
        mixl = scale_h
        w_star = kz_layer / mixl
        eta = 2e-4 * (t_layer / 300.0) ** 0.7              # poise, approx
        r_w = np.sqrt(np.maximum(
            9.0 * eta * fsed_arr * w_star / (2.0 * rho_c * grav), 0.0))
        r_eff = r_w * np.exp(-0.5 * np.log(atmo.sig) ** 2)  # lognormal
        r_eff = np.clip(r_eff, 1e-7, 1e-1)

        # optical depth: opd = 3 q_c colden Qext / (4 rho_c r_eff)
        mie = _load_gas_mieff(gas, directory)
        for i in range(nlayer):
            if q_c[i] <= 0:
                continue
            qe, qs, cq = _mie_at(mie, r_eff[i], wave_um)
            tau = 3.0 * q_c[i] * colden[i] * qe / (4.0 * rho_c * r_eff[i])
            tau = tau[::-1]   # back to ascending wavenumber
            ssa = (qs / np.maximum(qe, 1e-30))[::-1]
            asy = cq[::-1]
            # co-add with existing condensates (opd-weighted w0/g0)
            tot = opd[i] + tau
            w0n[i] = np.where(tot > 0,
                              (w0n[i] * opd[i] + ssa * tau) / tot, 0.0)
            g0n[i] = np.where(tot > 0,
                              (g0n[i] * opd[i] + asy * tau) / tot, 0.0)
            opd[i] = tot
        out_cond[gas] = dict(q_c=q_c, q_t=q_t, r_eff=r_eff, ibase=ibase)

    return {'opd_per_layer': opd, 'single_scattering': w0n,
            'asymmetry': g0n, 'wave': 1e4 / wno_grid,
            'pressure': p_layer, 'temperature': t_layer,
            'condensibles': out_cond,
            'scalar_inputs': {'fsed': atmo.fsed, 'mh': atmo.mh,
                              'sig': atmo.sig, 'mmw': atmo.mmw}}


def _load_gas_mieff(gas, directory):
    if directory is None:
        return None
    fn = os.path.join(directory, f'{gas}.mieff')
    if not os.path.exists(fn):
        return None
    return load_mieff(fn)


def picaso_format(opd, w0, g0, pressure=None, wavenumber=None):
    """Flatten cloud arrays to the .cld dataframe layout (virga API)."""
    opd = np.asarray(opd)
    nl, nw = opd.shape
    df = pd.DataFrame({'opd': opd.ravel(),
                       'w0': np.asarray(w0).ravel(),
                       'g0': np.asarray(g0).ravel()})
    if wavenumber is not None:
        # label each row with the wavenumber of ITS column — sorting the
        # labels here would misalign them with the data
        df['wavenumber'] = np.tile(np.asarray(wavenumber), nl)
    if pressure is not None:
        df['pressure'] = np.repeat(np.asarray(pressure), nw)
    return df
