"""User-facing API: scene construction and spectrum orchestration.

This module mirrors the ergonomics of the reference's ``justdoit``
(``/root/reference/picaso/justdoit.py``): ``opannection()`` +
``inputs().phase_angle/gravity/star/atmosphere/clouds/approx/spectrum()``.
The internals are redesigned device-first:

* the opacity database loads ONCE into HBM-resident grids
  (:mod:`picaso_tpu.opacities.db`); per-spectrum calls do zero host I/O
  (the reference re-queries sqlite per call, optics.py:2241-2308);
* the correlated-k gauss axis and the disk (gauss x chebyshev) facet axes
  are ``vmap`` batch axes of single fused XLA programs instead of Python
  loops (justdoit.py:254-406);
* all approximation options compile to static ints/bools on a frozen
  controls object, the jit analog of the reference's enum-compiled numba
  options (justdoit.py:4635-4738).
"""

from __future__ import annotations

import copy
import json
import os
import warnings as _warnings

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd

from . import disco as disco_mod
from . import raman as raman_mod
from . import rayleigh as rayleigh_mod
from . import units as u
from .atmosphere import Atmosphere, build_atmosphere
from .constants import PCONV, SB_SIGMA
from .opacities import assemble
from .opacities.db import (OpacityGrid, interp_molecular,
                           interp_molecular_nearest, load_opacity_db,
                           nearest_continuum)
from .optics import RTProps, combine_optics
from .refdata import load_default_config, refdata_path
from .rt import toon
from .rt.transit import transit_depth
from .wavelength import get_cld_input_grid, mean_regrid

__all__ = ['opannection', 'inputs', 'picaso', 'jupiter_pt', 'jupiter_cld',
           'HJ_pt', 'HJ_cld', 'brown_dwarf_pt', 'brown_dwarf_cld',
           'single_phase_options', 'multi_phase_options', 'raman_options',
           'toon_phase_coefficients', 'rt_methodology_options',
           'stream_options', 'mean_regrid']


# ---------------------------------------------------------------------------
# option enumerators (index = integer enum used by the kernels)
# ---------------------------------------------------------------------------

def single_phase_options(printout=True):
    return ['cahoy', 'OTHG', 'TTHG', 'TTHG_ray']


def multi_phase_options(printout=True):
    return ['N=2', 'N=1', 'isotropic']


def raman_options():
    return ['oklopcic', 'pollack', 'none']


def toon_phase_coefficients(printout=True):
    return ['quadrature', 'eddington']


def rt_methodology_options(printout=True):
    return ['toon', 'SH']


def stream_options(printout=True):
    return [2, 4]


def SH_scattering_options(printout=True):
    return ['TTHG', 'OTHG', 'isotropic']


def SH_rayleigh_options(printout=True):
    return ['off', 'on']


def SH_psingle_form_options(printout=True):
    return ['explicit', 'legendre']


def SH_calculate_fluxes_options(printout=True):
    return ['off', 'on']


# ---------------------------------------------------------------------------
# opacity connection
# ---------------------------------------------------------------------------

class Opacity:
    """Connected opacity source: wavenumber grid + device-resident tables.

    The device analog of the reference ``RetrieveOpacities``/``RetrieveCKs``
    union.  ``grid`` is None for analytic (test-mode) connections.
    """

    def __init__(self, wno, grid=None, raman_db=None, ngauss=1,
                 gauss_wts=None, ck=None, query_method='linear'):
        if query_method not in ('linear', 'nearest'):
            raise ValueError("query_method must be 'linear' (4-point "
                             "bilinear, optics.py:2241) or 'nearest' "
                             "(optics.py:2310, the reference default)")
        self.query_method = query_method
        self.wno = np.asarray(wno)
        self.wave = 1e4 / self.wno
        self.nwno = len(self.wno)
        self.ngauss = ngauss
        self.gauss_wts = (np.asarray(gauss_wts) if gauss_wts is not None
                          else np.array([1.0]))
        self.grid: OpacityGrid | None = grid
        self.ck = ck   # CKTable for correlated-k connections
        self.raman_db = raman_db
        self.molecules = (tuple(grid.molecules) if grid is not None
                          else (tuple(ck.molecules) if ck is not None else ()))
        self.avail_continuum = (
            list(grid.continuum_molecules) if grid is not None
            else (list(ck.continuum_molecules) if ck is not None else []))
        # rayleigh cross sections, once per grid (optics.py:2041-2046)
        self.rayleigh_molecules = rayleigh_mod.RAYLEIGH_MOLECULES
        self.rayleigh_opa = rayleigh_mod.rayleigh_sigma_table(self.wno)
        # stellar info bound by inputs.star()
        self.unshifted_stellar_spec = None
        self.relative_flux = None
        self.raman_stellar_shifts = None
        if ck is not None:
            self.delta_wno = np.asarray(ck.delta_wno)

    @property
    def full_abunds(self):
        """CK chemistry table (None for monochromatic connections)."""
        return self.ck.full_abunds if self.ck is not None else None

    def preload_opacities(self, molecules=None):
        """API parity with optics.py:2126: the reference lazily loads
        sqlite rows per run; here the full grid is already device-resident
        (HBM) from load_opacity_db, so this validates the request only."""
        if molecules and self.grid is not None:
            missing = [m for m in np.atleast_1d(molecules)
                       if m not in self.grid.molecules]
            if missing:
                raise ValueError(f'molecules not in database: {missing}')
        return self

    def compute_stellar_shifts(self, wno_star, flux_star):
        shifts, unshifted = raman_mod.compute_stellar_shifts(
            self.wno, self.raman_db, wno_star, flux_star)
        self.raman_stellar_shifts = shifts
        self.unshifted_stellar_spec = unshifted


def opannection(wave_range=None, filename_db=None, raman_db=None,
                resample=1, method='resampled', ck_db=None, wno_grid=None,
                molecules=None, verbose=True, ck_table=None,
                query_method='linear', **kwargs):
    """Connect to an opacity source (analog of justdoit.py:1296-1419).

    Parameters
    ----------
    wave_range : list
        [min, max] wavelength window in micron.
    filename_db : str
        sqlite monochromatic database (reference schema).  Defaults to
        ``$picaso_refdata/opacities/opacities.db`` if present.
    method : str
        'resampled' (monochromatic sqlite), 'preweighted' (premixed CK) or
        'resortrebin' (per-gas CK); CK paths take ``ck_db``.
    wno_grid : array, optional
        Build an analytic connection with this wavenumber grid and no
        molecular database — enough for test_mode runs and retrievals with
        user-supplied cross sections.
    """
    if raman_db is None:
        raman_db = refdata_path('opacities', 'raman.txt')
    raman_table = raman_mod.load_raman_db(raman_db)

    if wno_grid is not None:
        wno = np.sort(np.asarray(wno_grid, dtype=np.float64))
        if wave_range is not None:
            wave = 1e4 / wno
            sel = (wave > min(wave_range)) & (wave < max(wave_range))
            wno = wno[sel]
        return Opacity(wno, grid=None, raman_db=raman_table)

    if ck_table is not None or method in ('preweighted', 'resortrebin'):
        if ck_table is None:
            from .opacities.ck import load_ck_db
            ck_table = load_ck_db(ck_db, method=method, **kwargs)
        return Opacity(ck_table.wno, grid=None, raman_db=raman_table,
                       ngauss=ck_table.ngauss,
                       gauss_wts=np.asarray(ck_table.gauss_wts),
                       ck=ck_table)

    if filename_db is None:
        default = None
        try:
            default = refdata_path('opacities', 'opacities.db')
        except FileNotFoundError:
            pass
        if default is None:
            raise ValueError(
                'No opacity database found. Pass filename_db=, set '
                'picaso_refdata, or use wno_grid= for an analytic '
                'connection.')
        filename_db = default
    grid = load_opacity_db(filename_db, wave_range=wave_range,
                           resample=resample, molecules=molecules)
    return Opacity(np.asarray(grid.wno), grid=grid, raman_db=raman_table,
                   query_method=query_method)


# ---------------------------------------------------------------------------
# the inputs bundle
# ---------------------------------------------------------------------------

class inputs:
    """Scene builder with the reference method surface (justdoit.py:1421)."""

    def __init__(self, calculation='planet', climate=False):
        self.inputs = load_default_config()
        self.inputs['phase_angle'] = None
        if 'brown' in calculation:
            self.setup_nostar()
        if climate:
            self.setup_climate()

    # -- geometry ----------------------------------------------------------
    def phase_angle(self, phase=0, num_gangle=10, num_tangle=1,
                    symmetry=False, phase_grid=None, calculation=None):
        if phase_grid is not None:
            if calculation is None:
                raise ValueError("phase curves require calculation="
                                 "'reflected' or 'thermal'")
            self.phase_curve_geometry(calculation, phase_grid,
                                      num_gangle=num_gangle,
                                      num_tangle=num_tangle)
            return
        geom = disco_mod.make_geometry(phase, num_gangle, num_tangle)
        self.inputs['phase_angle'] = phase
        self.inputs['disco'] = geom

    def phase_curve_geometry(self, calculation, phase_grid, num_gangle=10,
                             num_tangle=10):
        phase_grid = np.asarray(phase_grid)
        if phase_grid.min() < 0 or phase_grid.max() > 2 * np.pi:
            raise ValueError('phase_grid must be within [0, 2pi] radians')
        self.inputs['phase_angle'] = phase_grid
        geoms = {}
        for iphase in phase_grid:
            # thermal flux emits at all angles -> same geometry at each phase
            p = 0.0 if calculation == 'thermal' else float(iphase)
            geoms[float(iphase)] = disco_mod.make_geometry(
                p, num_gangle, num_tangle)
        self.inputs['disco'] = geoms
        self.inputs['disco_calculation'] = calculation

    # -- planet ------------------------------------------------------------
    def gravity(self, gravity=None, gravity_unit=None, radius=None,
                radius_unit=None, mass=None, mass_unit=None):
        from .constants import G_GRAV
        if (mass is not None) and (radius is not None):
            m = u.to_cgs(mass, mass_unit)
            r = u.to_cgs(radius, radius_unit)
            self.inputs['planet'].update(
                radius=r, radius_unit='cm', mass=m, mass_unit='g',
                gravity=G_GRAV * m / r ** 2, gravity_unit='cm/(s**2)')
        elif gravity is not None:
            g = u.to_cgs(gravity, gravity_unit)
            self.inputs['planet'].update(
                gravity=g, gravity_unit='cm/(s**2)', radius=np.nan,
                radius_unit='Radius not specified', mass=np.nan,
                mass_unit='Mass not specified')
        else:
            raise ValueError('Need gravity+unit or radius+mass+units')

    def setup_nostar(self):
        self.inputs['approx']['rt_params']['common']['raman'] = 2
        self.inputs['star'] = {'database': 'nostar', 'temp': 'nostar',
                               'logg': 'nostar', 'metal': 'nostar',
                               'radius': 'nostar', 'radius_unit': 'nostar',
                               'semi_major': np.nan,
                               'semi_major_unit': 'nostar'}

    def star(self, opannection, temp=None, metal=None, logg=None,
             radius=None, radius_unit=None, semi_major=None,
             semi_major_unit=None, database='blackbody', filename=None,
             w_unit=None, f_unit=None, wno=None, flux=None):
        """Bind a stellar spectrum to the opacity connection.

        Sources (vs the reference's stsynphot pull, justdoit.py:
        1756-1912): a two-column file, explicit (wno, flux) arrays, or a
        blackbody at ``temp`` (default when no stellar grid files are
        installed).  Flux values are PER-WAVELENGTH [erg/cm^2/s/cm] —
        the unit the reference's synphot spectra arrive in
        (justdoit.py:1790) and the one every consumer shares: fpfs
        divides the per-wavelength thermal flux, and the climate path
        integrates F dlambda per bin.
        """
        r = u.to_cgs(radius, radius_unit) if radius is not None else np.nan
        sa = (u.to_cgs(semi_major, semi_major_unit)
              if semi_major is not None else np.nan)
        if np.isnan(sa) and 'climate' in str(self.inputs.get('calculation')):
            raise ValueError('climate runs need star semi_major + unit')

        if filename is not None:
            star = np.genfromtxt(filename, dtype=(float, float), names='w, f')
            wave_in = star['w'] * u.Unit(w_unit).cgs_factor  # -> cm
            wno_star = np.sort(1.0 / wave_in)
            order = np.argsort(1.0 / wave_in)
            flux_star = (star['f'] * u.Unit(f_unit).cgs_factor)[order]
        elif wno is not None and flux is not None:
            wno_star = np.asarray(wno, dtype=float)
            flux_star = np.asarray(flux, dtype=float)
        elif database in ('phoenix', 'ck04models'):
            # CDBS grid trees read with the bundled FITS parser
            # (stellar.py; replaces the stsynphot Icat path)
            from .stellar import get_stellar_spectrum
            wno_star, flux_star = get_stellar_spectrum(
                database, temp, metal, logg)
        elif temp is not None:
            # blackbody fallback: pi * B_lambda (erg/cm^2/s/cm — the
            # shared per-wavelength stellar convention; a per-wavenumber
            # B here tilts fpfs by lambda^2 and starves the climate's
            # visible heating)
            wno_star = np.linspace(
                max(np.min(opannection.wno) - 2500, 10.0),
                np.max(opannection.wno) + 7000, opannection.nwno * 5 + 1000)
            from .constants import PLANCK_C1, PLANCK_C2
            lam = 1.0 / wno_star
            flux_star = (np.pi * PLANCK_C1 / lam ** 5
                         / (np.exp(PLANCK_C2 / (lam * temp)) - 1.0))
        else:
            raise ValueError('give filename, (wno, flux) arrays, or temp')

        wno_planet = opannection.wno
        if self.inputs['approx']['rt_params']['common']['raman'] == 0:
            max_shift = np.max(wno_planet) + 6000
            min_shift = np.min(wno_planet) - 2000
            fine_wno = np.linspace(min_shift, max_shift, len(wno_planet) * 5)
            fine_flux = np.interp(fine_wno, wno_star, flux_star)
            opannection.compute_stellar_shifts(fine_wno, fine_flux)
            bin_flux = opannection.unshifted_stellar_spec
        elif 'climate' in str(self.inputs.get('calculation')):
            # trapezoid bin-integrated stellar flux (justdoit.py:1843-1879):
            # per-bin ENERGY [erg/cm^2/s] = integral of the per-wavelength
            # flux over dlambda, consumed by the climate visible fluxes as
            # plain bin sums (climate.py:1839-1841 sums without dwni)
            mask = flux_star > 1e-30
            lw, lf = np.log10(wno_star[mask]), np.log10(flux_star[mask])
            fine = 10 ** np.interp(np.log10(wno_planet), lw, lf)
            binned = np.zeros(len(wno_planet))
            for i in range(len(wno_planet) - 1):
                sel = (wno_planet >= wno_planet[i]) & (
                    wno_planet <= wno_planet[i + 1])
                binned[i] = np.trapezoid(fine[sel], x=-1 / wno_planet[sel])
            if len(wno_planet) > 2:
                slope = ((binned[-2] - binned[-3])
                         / (wno_planet[-2] - wno_planet[-3]))
                binned[-1] = binned[-2] + slope * (
                    wno_planet[-1] - wno_planet[-2])
            bin_flux = binned
            opannection.unshifted_stellar_spec = bin_flux
        else:
            interp_flux = np.interp(wno_planet, wno_star, flux_star)
            _, bin_flux = mean_regrid(wno_star, flux_star, newx=wno_planet)
            bad = np.isnan(bin_flux)
            bin_flux[bad] = interp_flux[bad]
            opannection.unshifted_stellar_spec = bin_flux

        if (not np.isnan(sa)) and (not np.isnan(r)):
            opannection.relative_flux = bin_flux * (r / sa) ** 2
        else:
            opannection.relative_flux = bin_flux * 0 + 1.0

        self.inputs['star'].update(
            database=database, temp=temp, logg=logg, metal=metal, radius=r,
            radius_unit='cm' if not np.isnan(r) else 'Radius not supplied',
            semi_major=sa, flux=bin_flux, wno=wno_planet, filename=filename,
            w_unit=w_unit, f_unit=f_unit)

    # -- atmosphere --------------------------------------------------------
    def atmosphere(self, df=None, filename=None, exclude_mol=None,
                   verbose=True, photochem_init_args=None,
                   photochem_TOA_pressure=1e-7 * 1e6, mh=None,
                   cto_relative=None, cto_absolute=None, chem_method=None,
                   **pd_kwargs):
        # chemistry knobs (justdoit.py:2043-2117): mh is LINEAR
        # metallicity (1.0 = solar); a chem_method triggers the grid
        # chemistry once the PT profile is bound below
        for key, val in (('mh', mh), ('cto_relative', cto_relative),
                         ('cto_absolute', cto_absolute)):
            if val is not None:
                self.inputs['atmosphere'][key] = float(val)
        if photochem_init_args is not None:
            # stored for photochem_init (justdoit.py:2058-2060)
            photochem_init_args = dict(photochem_init_args)
            photochem_init_args['TOA_pressure'] = photochem_TOA_pressure
            self.inputs['atmosphere']['photochem_init_args'] = \
                photochem_init_args
        if filename is not None:
            df = pd.read_csv(filename, **pd_kwargs)
        if df is None:
            raise ValueError('give df= or filename=')
        if isinstance(df, dict):
            df = pd.DataFrame(df)
        if 'pressure' not in df or 'temperature' not in df:
            raise ValueError('profile needs pressure and temperature columns')
        df = df.sort_values('pressure').reset_index(drop=True)
        self.inputs['atmosphere']['profile'] = df
        self.nlevel = df.shape[0]
        if exclude_mol is None:
            self.inputs['atmosphere']['exclude_mol'] = 1
        else:
            # dict of multipliers, missing molecules default to 1
            full = {m: 1 for m in df.keys()
                    if m not in ('pressure', 'temperature')}
            full.update({m: 0 for m in np.atleast_1d(exclude_mol)}
                        if not isinstance(exclude_mol, dict) else exclude_mol)
            self.inputs['atmosphere']['exclude_mol'] = full
        if chem_method is not None:
            self.chemistry_handler(chem_method)

    def atmosphere_3d(self, data, verbose=True):
        """3D GCM input: a NetCDF path / decoded NCDataset (the
        reference's xarray GCM format, justdoit.py:3414) or a dict with
        'lat'/'lon' (deg), 'pressure' [nlevel] (bar), and
        [nlevel, nlon, nlat] fields; columns are selected at the disco
        facets by nearest neighbour instead of xarray exact-matching."""
        from .ncio import NCDataset, gcm_dict
        if isinstance(data, (str, bytes, NCDataset)):
            data = gcm_dict(data)
        if 'pressure' not in data or 'temperature' not in data:
            raise ValueError('need pressure and temperature fields')
        self.inputs['atmosphere']['profile'] = data
        self.nlevel = len(np.asarray(data['pressure']))

    def clouds_3d(self, opd=None, g0=None, w0=None, wavenumber=None):
        """Facet-dependent clouds: [nlayer, nwno_cld, ng, nt] arrays."""
        self.inputs['clouds']['profile'] = {'opd': opd, 'g0': g0, 'w0': w0}
        self.inputs['clouds']['wavenumber'] = wavenumber

    @staticmethod
    def _rotate_lon(data, total_shift_deg, lon_axis):
        """Roll gridded fields so longitude zero moves by ``total_shift``.

        Equivalent of the reference's split-and-concatenate rotation
        (justdoit.py:3829-3838): shift the longitude coordinate by
        ``total_shift``, wrap into [-180, 180), and reorder the data so the
        stored 'lon' axis stays monotonically increasing.
        """
        lon = np.asarray(data['lon'], float)
        new_zero = (lon + total_shift_deg + 180.0) % 360.0 - 180.0
        split = int(np.argmin(np.abs(new_zero + 180.0)))
        out = {}
        for key, val in data.items():
            val = np.asarray(val)
            if key in ('lat', 'lon', 'pressure', 'wavenumber') \
                    or val.ndim <= 1:
                out[key] = val
            else:
                out[key] = np.concatenate(
                    [np.take(val, range(split, val.shape[lon_axis]),
                             axis=lon_axis),
                     np.take(val, range(split), axis=lon_axis)],
                    axis=lon_axis)
        return out

    def atmosphere_4d(self, ds=None, shift=None, plot=False, iz_plot=0,
                      verbose=True, zero_point='night_transit'):
        """Phase-dependent GCM rotation (analog of justdoit.py:3666-3873).

        For every phase set by ``phase_curve_geometry`` the GCM longitude
        grid is rotated by ``phase + shift_i`` degrees (``shift`` defaults
        to zero — tidally locked) and stored as a per-phase 3D profile
        list consumed by :meth:`phase_curve`.  ``zero_point`` follows the
        reference: 'night_transit' adds 180 deg for thermal phase curves
        (reflected always uses the secondary-eclipse zero point,
        justdoit.py:3706-3717).  The reference's micro_shift/shift_back
        bookkeeping (justdoit.py:3770-3821) compensates its in-place
        longitude-coordinate rewrite; here each phase's disco geometry
        keeps its own facet longitudes and the regrid happens at spectrum
        time (three_d.regrid_to_disco), so only the physical rotation is
        applied.
        """
        from .ncio import NCDataset, gcm_dict
        if isinstance(ds, (str, bytes, NCDataset)):
            ds = gcm_dict(ds)
        if ds is None:
            ds = self.inputs['atmosphere']['profile']
        if not isinstance(ds, dict) or 'lat' not in ds:
            raise ValueError("atmosphere_4d needs a 3D GCM dict with "
                             "'lat'/'lon'/'pressure' + [nlevel,nlon,nlat] "
                             "fields (see atmosphere_3d)")
        phases = np.atleast_1d(self.inputs['phase_angle'])
        if shift is None:
            shift = np.zeros(len(phases))
        shift = np.asarray(shift, float)
        if len(shift) != len(phases):
            raise ValueError('shift must have one entry per phase')
        calculation = self.inputs.get('disco_calculation', 'thermal')
        if zero_point == 'night_transit':
            if 'reflected' in calculation:
                if verbose:
                    print('Switching to zero point secondary_eclipse '
                          'which is required for reflected light')
            else:
                shift = shift + 180.0
        elif zero_point != 'secondary_eclipse':
            raise ValueError('zero_point must be night_transit or '
                             'secondary_eclipse')
        self.inputs['shift'] = shift
        profiles = []
        for i, iphase in enumerate(phases):
            total = (np.degrees(float(iphase)) + shift[i]) % 360.0
            profiles.append(self._rotate_lon(ds, total, lon_axis=1))
        self.inputs['atmosphere']['profile'] = profiles
        self.nlevel = len(np.asarray(ds['pressure']))
        if plot:  # pragma: no cover - convenience visual check
            from . import justplotit
            justplotit.map_4d(profiles, phases, iz_plot=iz_plot)
        return profiles

    def clouds_4d(self, ds=None, plot=False, iz_plot=0, iw_plot=0,
                  verbose=True, calculation='reflected'):
        """Phase-dependent cloud rotation + facet regrid (justdoit.py:3875).

        ``ds``: dict with 'lat'/'lon' (deg), 'wavenumber' [nwno_cld] and
        'opd'/'g0'/'w0' arrays [nlayer, nwno_cld, nlon, nlat].  Uses the
        shifts recorded by :meth:`atmosphere_4d` and each phase's disco
        geometry; stores a per-phase list of facet cloud dicts
        ([nlayer, nwno_cld, ng, nt]) for :meth:`phase_curve`.
        """
        from .three_d import regrid_to_disco
        from .ncio import NCDataset, gcm_dict
        if isinstance(ds, (str, bytes, NCDataset)):
            ds = gcm_dict(ds)
        if ds is None:
            ds = self.inputs['clouds'].get('profile')
        if not isinstance(ds, dict) or 'lat' not in ds:
            raise ValueError("clouds_4d needs a dict with 'lat'/'lon' and "
                             "[nlayer,nwno,nlon,nlat] opd/g0/w0 fields")
        phases = np.atleast_1d(self.inputs['phase_angle'])
        shift = np.asarray(self.inputs.get('shift',
                                           np.zeros(len(phases))), float)
        geoms = self.inputs['disco']
        per_phase = []
        for i, iphase in enumerate(phases):
            total = (np.degrees(float(iphase)) + shift[i]) % 360.0
            rot = self._rotate_lon(ds, total, lon_axis=2)
            faceted = regrid_to_disco(
                {k: rot[k] for k in ('lat', 'lon', 'opd', 'g0', 'w0')},
                geoms[float(iphase)], field_lon_axis=2)
            per_phase.append({k: faceted[k] for k in ('opd', 'g0', 'w0')})
        self.inputs['clouds']['profile'] = per_phase
        self.inputs['clouds']['wavenumber'] = np.asarray(ds['wavenumber'])
        return per_phase

    def sonora(self, sonora_path, teff, chem='low'):
        """Nearest Sonora Bobcat PT + chemistry (justdoit.py:2759)."""
        return self.sonora_profile(sonora_path, teff, chem=chem)

    def TP_line_earth(self, P, Tsfc=294.0, Psfc=1.0, gam_trop=0.18,
                      Ptrop=0.199, gam_strat=-0.045, Pstrat=0.001,
                      nlevel=150):
        """Earth-like piecewise lapse-rate T(P) (justdoit.py:3351).

        Dry-adiabat troposphere from (Tsfc, Psfc), power-law
        stratosphere above Ptrop, isothermal below the surface and above
        Pstrat, clipped to [10, 1000] K; stored as the atmosphere
        profile.
        """
        P = np.asarray(P, float)
        Ptrop = max(Ptrop, P.min())
        Pstrat = max(Pstrat, P.min())
        T_trop = Tsfc * (P / Psfc) ** gam_trop
        T_pause = T_trop[P <= Ptrop][-1]
        P_pause = P[P <= Ptrop][-1]
        T_strat = T_pause * (P / P_pause) ** gam_strat
        T = np.where(P >= Ptrop, T_trop, T_strat)
        if (P >= Psfc).any():
            T[P >= Psfc] = T[P >= Psfc][0]
        T[P <= Pstrat] = T[P <= Pstrat][-1]
        T = np.clip(T, 10.0, 1000.0)
        self.inputs['atmosphere']['profile'] = pd.DataFrame(
            {'temperature': T, 'pressure': P})
        self.nlevel = len(P)
        return self.inputs['atmosphere']['profile']

    def guillot_pt(self, Teq, T_int=100, logg1=-1, logKir=-1.5, alpha=0.5,
                   nlevel=61, p_bottom=1.5, p_top=-6):
        """Parameterized Guillot 2010 profile (port of justdoit.py:3283)."""
        pressure = np.logspace(p_top, p_bottom, nlevel)
        g = self.inputs['planet']['gravity'] / 100.0  # SI
        kv1 = kv2 = 10 ** (logKir + logg1)
        kth = 10 ** logKir
        alpha = float(alpha)
        tint, tirr = T_int, np.sqrt(2.0) * Teq
        gamma1 = kv1 / kth
        gamma2 = kv2 / kth
        tau = pressure * 1e5 / g / kth
        from scipy.special import expn
        xi1 = (2.0 / 3 + 2.0 / (3 * gamma1)
               * (1 + (gamma1 * tau / 2 - 1) * np.exp(-gamma1 * tau))
               + 2.0 * gamma1 / 3 * (1 - tau ** 2 / 2) * expn(2, gamma1 * tau))
        xi2 = (2.0 / 3 + 2.0 / (3 * gamma2)
               * (1 + (gamma2 * tau / 2 - 1) * np.exp(-gamma2 * tau))
               + 2.0 * gamma2 / 3 * (1 - tau ** 2 / 2) * expn(2, gamma2 * tau))
        temp = (3.0 * tint ** 4 / 4 * (2.0 / 3 + tau)
                + 3.0 * tirr ** 4 / 4 * (1 - alpha) * xi1
                + 3.0 * tirr ** 4 / 4 * alpha * xi2) ** 0.25
        self.inputs['atmosphere']['pt_params'] = dict(
            Teq=Teq, T_int=T_int, logg1=logg1, logKir=logKir, alpha=alpha)
        return pd.DataFrame({'pressure': pressure, 'temperature': temp})

    def add_pt(self, T, P):
        df = self.inputs['atmosphere']['profile']
        if df is None:
            df = pd.DataFrame({'pressure': P, 'temperature': T})
        else:
            df['temperature'] = T
            df['pressure'] = P
        self.inputs['atmosphere']['profile'] = df
        self.nlevel = df.shape[0]

    def premix_atmosphere(self, opa=None, df=None, quench_levels=None,
                          verbose=True):
        """Set equilibrium chemistry from the opacity connection's
        full_abunds table (justdoit.py:2237-2282 semantics)."""
        from . import chemistry as chem_mod
        table = None
        if opa is not None and getattr(opa, 'ck', None) is not None:
            table = opa.ck.full_abunds
        if table is None:
            raise ValueError('premix_atmosphere needs a CK connection with '
                             'a full_abunds chemistry table')
        prof = df if df is not None else self.inputs['atmosphere']['profile']
        grid = chem_mod.chem_grid_from_table(table)
        abunds = np.asarray(chem_mod.chem_interp(
            grid, jnp.asarray(np.asarray(prof['temperature'], float)),
            jnp.asarray(np.asarray(prof['pressure'], float))))
        out = pd.DataFrame({'pressure': np.asarray(prof['pressure']),
                            'temperature': np.asarray(prof['temperature'])})
        for i, sp in enumerate(grid.species):
            out[sp] = abunds[:, i]
        self.inputs['atmosphere']['profile'] = out
        self.nlevel = out.shape[0]
        return out

    def premix_atmosphere_photochem(self, opa=None, quench_levels=None,
                                    verbose=False, **kwargs):
        """Run the photochemistry model and load its steady-state gas
        concentrations into the profile (justdoit.py:2283-2323).

        Sequence matches the reference: refresh equilibrium chemistry
        (when ``opa`` is given), quench-adjust as the kinetics initial
        guess, then drive ``pc.run_for_picaso`` warm-started from the
        previous steady state stored in
        ``inputs['photochemistry']['initial_guess']``.  Requires
        :meth:`photochem_init` (or any object with the same
        ``run_for_picaso`` interface assigned to
        ``inputs['climate']['pc']`` — the test suite uses a mock there).
        """
        if opa is not None:
            self.premix_atmosphere(opa=opa, **kwargs)
        if quench_levels is not None:
            self.adjust_quench_chemistry(quench_levels)
        pc = self.inputs['climate'].get('pc')
        if pc is None:
            raise ValueError('initialize kinetics with photochem_init() '
                             'before premix_atmosphere_photochem()')
        kz = self.find_kzz()
        if kz is None:
            raise ValueError('photochem kinetics needs a kzz profile')
        store = self.inputs.setdefault('photochemistry',
                                       {'initial_guess': None})
        mh = float(self.inputs['atmosphere'].get('mh') or 1.0)
        cto = float(self.inputs['atmosphere'].get('cto_relative') or 1.0)
        # warm start: this session's last steady state, else the newest
        # record restored from pc's save_file (cross-process resume)
        guess = store.get('initial_guess')
        if guess is None:
            guess = getattr(pc, 'initial_guess', None)
        df = pc.run_for_picaso(self.inputs['atmosphere']['profile'],
                               np.log10(mh), cto, kz,
                               df_comp_guess=guess)
        store['initial_guess'] = df.copy()
        self.inputs['atmosphere']['profile'] = df
        return df

    def photochem_init(self):
        """Initialize the photochem kinetics wrapper from the args stored
        by atmosphere(photochem_init_args=...) (justdoit.py:4933-4951);
        gated on the optional photochem package."""
        args = self.inputs['atmosphere'].get('photochem_init_args')
        if args is None:
            raise ValueError('pass photochem_init_args to atmosphere() '
                             'before photochem_init()')
        mass = self.inputs['planet']['mass']
        radius = self.inputs['planet']['radius']
        if np.isnan(mass) or np.isnan(radius):
            raise ValueError('photochem needs mass and radius via '
                             'gravity(mass=..., radius=...)')
        args = dict(args)
        toa_pressure = args.pop('TOA_pressure')
        args['planet_mass'] = mass
        args['planet_radius'] = radius
        from .photochem import EvoAtmosphereGasGiantPicaso
        pc = EvoAtmosphereGasGiantPicaso(**args)
        pc.gdat.TOA_pressure_avg = toa_pressure
        self.inputs['climate']['pc'] = pc
        return pc

    # -- clouds ------------------------------------------------------------
    def clouds_reset(self):
        self.inputs['clouds'] = {'profile': None, 'wavenumber': None,
                                 'scattering': {'g0': None, 'w0': None,
                                                'opd': None},
                                 'do_holes': False}

    def clouds(self, filename=None, g0=None, w0=None, opd=None, p=None,
               dp=None, df=None, do_holes=False, fhole=None, fthin_cld=None,
               **pd_kwargs):
        """Cloud profile: eddysed-layout table or g0/w0/opd/p/dp box model
        (port of justdoit.py:4126-4268)."""
        assert hasattr(self, 'nlevel'), 'run atmosphere() before clouds()'
        nlayer = self.nlevel - 1
        if filename is not None:
            df = pd.read_csv(filename, **pd_kwargs)
        if df is not None:
            if isinstance(df, dict):
                df = pd.DataFrame(df)
            for c in ('g0', 'w0', 'opd'):
                assert c in df.keys(), f'{c} must be a column in cld input'
            if ('pressure' in df.keys()) and ('wavenumber' in df.keys()):
                df = df.sort_values(['pressure', 'wavenumber']
                                    ).reset_index(drop=True)
                self.inputs['clouds']['wavenumber'] = \
                    df['wavenumber'].unique()
            else:
                if df.shape[0] == nlayer * 196:
                    self.inputs['clouds']['wavenumber'] = get_cld_input_grid()
                elif df.shape[0] == nlayer * 661:
                    self.inputs['clouds']['wavenumber'] = get_cld_input_grid(
                        grid661=True)
                else:
                    raise ValueError(
                        f'{df.shape[0]} rows != {nlayer} layers x 196 or '
                        '661 eddysed wave points')
            self.inputs['clouds']['profile'] = df
        elif None in [g0, w0, opd, p, dp]:
            raise ValueError('give df/filename OR all of g0,w0,opd,p,dp')
        else:
            pressure_level = np.asarray(
                self.inputs['atmosphere']['profile']['pressure'])
            pressure = np.sqrt(pressure_level[1:] * pressure_level[:-1])
            w = get_cld_input_grid()
            self.inputs['clouds']['wavenumber'] = w
            nw = len(w)
            g0a = np.zeros((nlayer, nw))
            w0a = np.zeros((nlayer, nw))
            opda = np.zeros((nlayer, nw))
            for ig, iw, io, ip, idp in zip(*map(np.atleast_1d,
                                                (g0, w0, opd, p, dp))):
                maxp, minp = 10.0 ** ip, 10.0 ** (ip - idp)
                sel = (pressure >= minp) & (pressure <= maxp)
                g0a[sel], w0a[sel], opda[sel] = ig, iw, io
            self.inputs['clouds']['profile'] = pd.DataFrame(
                {'g0': g0a.ravel(), 'w0': w0a.ravel(), 'opd': opda.ravel()})
        self.inputs['clouds']['do_holes'] = do_holes
        if do_holes:
            if fhole is None:
                raise ValueError('fhole must be set when do_holes=True')
            self.inputs['clouds']['fhole'] = fhole
            self.inputs['clouds']['fthin_cld'] = fthin_cld

    def virga(self, condensates, directory=None, fsed=1.0, b=1.0, eps=1e-2,
              param='const', mh=1.0, mmw=2.2, sig=2.0, kz_min=1e5,
              supsat=0, gas_mmr=None, Teff=None, alpha_pressure=None,
              do_virtual=False, full_output=False, solver='eddysed',
              **kwargs):
        """Run cloud microphysics and attach the resulting cloud profile
        (justdoit.py:4269-4399 semantics, using picaso_tpu.virga — the
        full AM01 eddy-sedimentation solver; point ``directory`` at
        virga .mieff files for real Mie optics).  ``param``/``b``/``eps``
        select the variable-fsed profile, ``do_virtual`` enables the
        below-grid virtual cloud, ``solver='analytic'`` picks the fast
        closed-form balance."""
        from . import virga as vj
        atmo = vj.Atmosphere(condensates, fsed=fsed, b=b, eps=eps,
                             param=param, mh=mh, mmw=mmw, sig=sig,
                             supsat=supsat, gas_mmr=gas_mmr, **kwargs)
        atmo.gravity = self.inputs['planet']['gravity']
        prof = self.inputs['atmosphere']['profile']
        atmo.ptk(df=prof, kz_min=kz_min, Teff=Teff,
                 alpha_pressure=alpha_pressure)
        out = vj.compute(atmo, directory=directory,
                         do_virtual=do_virtual, solver=solver)
        # pressure + wavenumber columns together make clouds() honor the
        # solver's actual wave grid (mieff grids need not be 196/661-pt)
        df_cld = vj.picaso_format(out['opd_per_layer'],
                                  out['single_scattering'],
                                  out['asymmetry'],
                                  pressure=out['pressure'],
                                  wavenumber=1e4 / out['wave'])
        self.clouds(df=df_cld)
        return out if full_output else df_cld

    def virga_3d(self, condensates, directory=None, fsed=1.0, mh=1.0,
                 mmw=2.2, sig=2.0, kz_min=1e5, n_cpu=1, verbose=False,
                 full_output=False, solver='eddysed', **kwargs):
        """Per-column cloud microphysics on the 3D GCM grid
        (justdoit.py:4400-4514).

        Requires :meth:`atmosphere_3d` input with a 'kz' field.  Runs the
        eddysed solve for every (lon, lat) column and stores the cloud
        arrays [nlayer, nwno, nlon, nlat] on the GCM grid; facet columns
        are selected at spectrum time by the same nearest-neighbour
        regrid as the atmosphere (three_d.regrid_to_disco) — the JAX
        build's replacement for the reference's joblib fan-out +
        xarray regrid.
        """
        from . import virga as vj
        prof = self.inputs['atmosphere']['profile']
        if not (isinstance(prof, dict) and 'lat' in prof):
            raise ValueError('virga_3d needs atmosphere_3d input '
                             '(dict with lat/lon grids)')
        if 'kz' not in prof:
            raise ValueError("virga_3d needs a 'kz' [cm^2/s] field in "
                             'the 3D profile')
        lat = np.asarray(prof['lat'], float)
        lon = np.asarray(prof['lon'], float)
        pressure = np.asarray(prof['pressure'], float)
        nlon, nlat = len(lon), len(lat)
        nlayer = len(pressure) - 1

        def one_column(ilon, ilat):
            df = pd.DataFrame({
                'pressure': pressure,
                'temperature': np.asarray(prof['temperature'])[:, ilon,
                                                               ilat],
                'kz': np.asarray(prof['kz'])[:, ilon, ilat]})
            atmo = vj.Atmosphere(condensates, fsed=fsed, mh=mh, mmw=mmw,
                                 sig=sig, **kwargs)
            atmo.gravity = self.inputs['planet']['gravity']
            atmo.ptk(df=df, kz_min=kz_min)
            return vj.compute(atmo, directory=directory, solver=solver)

        results = [one_column(g, t) for g in range(nlon)
                   for t in range(nlat)]
        wno_grid = np.sort(1e4 / results[0]['wave'])
        nwno = len(wno_grid)
        opd = np.zeros((nlayer, nwno, nlon, nlat))
        w0 = np.zeros_like(opd)
        g0 = np.zeros_like(opd)
        i = 0
        all_out = {}
        for g in range(nlon):
            for t in range(nlat):
                out = results[i]; i += 1
                opd[:, :, g, t] = out['opd_per_layer']
                w0[:, :, g, t] = out['single_scattering']
                g0[:, :, g, t] = out['asymmetry']
                if full_output:
                    all_out[f'lon{g}_lat{t}'] = out
        self.inputs['clouds']['profile'] = {
            'opd': opd, 'w0': w0, 'g0': g0, 'lat': lat, 'lon': lon,
            'pressure': pressure}
        self.inputs['clouds']['wavenumber'] = wno_grid
        if full_output:
            return all_out

    # -- disequilibrium chemistry adjustments --------------------------------
    def find_kzz(self):
        """Locate the active Kzz profile (constant / self-consistent /
        from the profile), mirroring the reference bookkeeping."""
        kz_store = self.inputs['atmosphere'].get('kzz', {})
        if isinstance(kz_store, dict):
            for key in ('sc_kzz', 'constant_kzz'):
                kz = kz_store.get(key)
                if kz is not None and not isinstance(kz, int):
                    return np.asarray(kz)
        prof = self.inputs['atmosphere']['profile']
        if prof is not None and 'kz' in getattr(prof, 'keys', lambda: [])():
            return np.asarray(prof['kz'])
        return None

    def adjust_quench_chemistry(self, quench_levels, chemistry_table=None,
                                kinetic_CO2=True):
        """Freeze quenched species above their quench level, conserving
        the total via H2 (justdoit.py:2340-2445 incl. the Zahnle & Marley
        eq. 43 kinetic CO2 fix)."""
        df = self.inputs['atmosphere']['profile']
        nlevel = df.shape[0]
        H2 = df['H2'].values.copy()
        for iquench in ['PH3', 'CO-CH4-H2O', 'CO2', 'NH3-N2', 'HCN']:
            if iquench not in quench_levels:
                continue
            qlev = min(int(quench_levels[iquench]), nlevel - 1)
            for imol in iquench.split('-'):
                if imol not in df.keys():
                    continue
                quench_abundance = df.loc[qlev, imol]
                old = df.loc[:, imol].values.copy()
                df.loc[0:qlev + 1, imol] = quench_abundance
                H2 = H2 + (old - df.loc[:, imol].values)
        if kinetic_CO2 and 'CO2' in quench_levels and \
                all(m in df.keys() for m in ('CO', 'H2O', 'CO2')):
            T = df['temperature']
            K = 18.3 * np.exp(-2376 / T - (932 / T) ** 2)
            fCO2 = (df['CO'] * df['H2O']) / (K * df['H2'])
            fCO2 = np.array(fCO2.values)
            qlev = min(int(quench_levels['CO2']), nlevel - 1)
            fCO2[:qlev] = fCO2[qlev]
            old = df.loc[:, 'CO2'].values.copy()
            df.loc[:, 'CO2'] = fCO2
            H2 = H2 + (old - df.loc[:, 'CO2'].values)
        df.loc[:, 'H2'] = H2
        self.inputs['atmosphere']['profile'] = df

    def volatile_rainout(self, quench_levels,
                         species_to_consider=('H2O', 'CH4', 'NH3')):
        """Cap quenched volatiles at their saturation vapor pressure
        (justdoit.py:2135-2196)."""
        from . import virga as vj
        df = self.inputs['atmosphere']['profile']
        quench_mols = np.concatenate([k.split('-')
                                      for k in quench_levels])
        H2 = df['H2'].values.copy()
        for imol in species_to_consider:
            if imol not in df.keys() or imol not in quench_mols:
                continue
            qlev = None
            for k, lev in quench_levels.items():
                if imol in k.split('-'):
                    qlev = min(int(lev), df.shape[0] - 1)
            if qlev is None:
                continue
            get_pvap = getattr(vj.pvaps, imol, None)
            if get_pvap is None:
                continue
            quench_abund = df.loc[qlev, imol]
            old = df.loc[:, imol].values.copy()
            for i in range(0, qlev + 1):
                pvap_abund = (get_pvap(df.loc[i, 'temperature'])
                              / (df.loc[i, 'pressure'] * 1e6))
                if pvap_abund < quench_abund:
                    df.loc[i, imol] = pvap_abund
            H2 = H2 + (old - df.loc[:, imol].values)
        df.loc[:, 'H2'] = H2
        self.inputs['atmosphere']['profile'] = df

    def cold_trap(self, species_to_consider=('H2O', 'CH4', 'NH3')):
        """Enforce non-increasing condensible abundances above the
        condensation layer (justdoit.py:2197-2236)."""
        from . import virga as vj
        df = self.inputs['atmosphere']['profile']
        H2 = df['H2'].values.copy()
        for mol in species_to_consider:
            if mol not in df.keys():
                continue
            _, cond_t = vj.condensation_t(
                mol, 1, 2.2, pressure=np.asarray(df['pressure']))
            cross = np.where(cond_t > np.asarray(df['temperature']))[0]
            if len(cross) == 0:
                continue
            cond_layer = int(cross[-1])
            old = df.loc[:, mol].values.copy()
            for i in range(cond_layer - 1, 0, -1):
                if df.loc[i, mol] < df.loc[i - 1, mol]:
                    df.loc[i - 1, mol] = df.loc[i, mol]
            H2 = H2 + (old - df.loc[:, mol].values)
        df.loc[:, 'H2'] = H2
        self.inputs['atmosphere']['profile'] = df

    # -- approximations ----------------------------------------------------
    def approx(self, single_phase='TTHG_ray', multi_phase='N=2',
               delta_eddington=True, raman='pollack', tthg_frac=[1, -1, 2],
               tthg_back=-0.5, tthg_forward=1, p_reference=1,
               rt_method='toon', stream=2, toon_coefficients='quadrature',
               single_form='explicit', calculate_fluxes='off',
               w_single_form='TTHG', w_multi_form='TTHG',
               psingle_form='TTHG', w_single_rayleigh='on',
               w_multi_rayleigh='on', psingle_rayleigh='on',
               get_lvl_flux=False):
        ap = self.inputs['approx']
        ap['get_lvl_flux'] = get_lvl_flux
        ap['rt_method'] = rt_method
        common = ap['rt_params']['common']
        common['stream'] = 2 if rt_method == 'toon' else stream
        common['delta_eddington'] = delta_eddington
        common['raman'] = raman_options().index(raman)
        if len(tthg_frac) != 3:
            raise ValueError('tthg_frac must have length 3')
        common['TTHG_params']['fraction'] = tthg_frac
        common['TTHG_params']['constant_back'] = tthg_back
        common['TTHG_params']['constant_forward'] = tthg_forward
        tp = ap['rt_params']['toon']
        tp['toon_coefficients'] = toon_phase_coefficients(False).index(
            toon_coefficients)
        tp['multi_phase'] = multi_phase_options(False).index(multi_phase)
        tp['single_phase'] = single_phase_options(False).index(single_phase)
        sh = ap['rt_params']['SH']
        sh['single_form'] = SH_psingle_form_options(False).index(single_form)
        sh['w_single_form'] = SH_scattering_options(False).index(w_single_form)
        sh['w_multi_form'] = SH_scattering_options(False).index(w_multi_form)
        sh['psingle_form'] = SH_scattering_options(False).index(psingle_form)
        sh['w_single_rayleigh'] = SH_rayleigh_options(False).index(
            w_single_rayleigh)
        sh['w_multi_rayleigh'] = SH_rayleigh_options(False).index(
            w_multi_rayleigh)
        sh['psingle_rayleigh'] = SH_rayleigh_options(False).index(
            psingle_rayleigh)
        sh['calculate_fluxes'] = SH_calculate_fluxes_options(False).index(
            calculate_fluxes)
        ap['p_reference'] = p_reference

    def surface_reflect(self, albedo, wavenumber, old_wavenumber=None):
        if isinstance(albedo, (int, float)):
            albedo = np.zeros(len(wavenumber)) + albedo
        if old_wavenumber is not None:
            albedo = np.interp(wavenumber, old_wavenumber, albedo)
        self.inputs['surface_reflect'] = np.asarray(albedo)

    def setup_climate(self):
        self.inputs['calculation'] = 'climate'
        self.inputs['approx']['rt_params']['common']['raman'] = 2
        self.phase_angle(0, num_gangle=10, num_tangle=1)

    def inputs_climate(self, **kw):
        from .climate.api import inputs_climate as _ic
        return _ic(self, **kw)

    def pressure_grid(self, P_config):
        """Pressure grid from a config dict (justdoit.py:3249):
        {'min': {'value', 'unit'}, 'max': {...}, 'nlevel', 'spacing'}."""
        def bar(entry):
            val = entry['value']
            unit = entry.get('unit', 'bar')
            return u.to_cgs(val, unit) / 1e6 if unit != 'bar' else val
        minp = bar(P_config['min'])
        maxp = bar(P_config['max'])
        nlevel = P_config.get('nlevel', 91)
        if P_config.get('spacing', 'log') == 'log':
            return np.logspace(np.log10(minp), np.log10(maxp), nlevel)
        return np.linspace(minp, maxp, nlevel)

    def chemistry_handler(self, chemistry_table=None):
        """Dispatch equilibrium chemistry from
        approx['chem_params']['chem_method'] (justdoit.py:2082): runs the
        matching visscher grid when the profile already has (P, T)."""
        chem = self.inputs['approx'].setdefault('chem_params', {})
        method = str(chemistry_table or chem.get('chem_method', ''))
        prof = self.inputs['atmosphere'].get('profile')
        has_pt = (prof is not None
                  and 'temperature' in getattr(prof, 'columns', ()))
        if not has_pt:
            chem['chem_method'] = method
            return
        # explicit None checks: the config tree carries these keys with
        # None defaults, so dict.get(default) alone won't coalesce.
        # 'mh' is LINEAR metallicity everywhere it is stored (reference
        # justdoit.py:2044/2112 — log10 applied at the grid lookup);
        # the 1060 grid takes C/O relative to solar, 2121 absolute.
        mh = chem.get('mh')
        if mh is None:
            mh = self.inputs['atmosphere'].get('mh')
        log_mh = 0.0 if mh is None else float(np.log10(mh))
        if '2121' in method:
            cto = chem.get('cto_absolute')
            if cto is None:
                cto = self.inputs['atmosphere'].get('cto_absolute')
            cto = 0.458 if cto is None else float(cto)
            self.chemeq_visscher_2121(cto, log_mh)
        elif 'visscher' in method or '1060' in method:
            cto = chem.get('cto_relative')
            if cto is None:
                cto = self.inputs['atmosphere'].get('cto_relative')
            cto = 1.0 if cto is None else float(cto)
            self.chemeq_visscher_1060(cto, log_mh)
        elif method and method != 'None':
            raise ValueError(f'unknown chem_method {method!r}')

    def interpret_run(self):
        """Print a human summary of the configured climate run
        (justdoit.py:4868)."""
        print('SUMMARY')
        print('-------')
        clim = self.inputs.get('climate', {})
        print('Clouds:', clim.get('cloudy', False))
        for k, v in self.inputs['approx'].get('chem_params', {}).items():
            print(k, v)
        print('Moist Adiabat:', clim.get('moistgrad', False))

    def energy_injection(self, inject_energy=False,
                         total_energy_injection=0, press_max_energy=1,
                         injection_scalehight=1, inject_beam=False,
                         beam_profile=0):
        """Energy deposition for climate runs (justdoit.py:4953-4980).

        Chapman-function deposition of ``total_energy_injection``
        [erg/cm^2/s] peaking at ``press_max_energy`` [bar], or a
        numerical ``beam_profile`` when ``inject_beam``; consumed by
        climate.core.tidal_flux.
        """
        self.inputs['climate']['inject_energy'] = inject_energy
        self.inputs['climate']['total_energy_injection'] = \
            total_energy_injection
        self.inputs['climate']['press_max_energy'] = press_max_energy
        self.inputs['climate']['injection_scaleheight'] = \
            injection_scalehight
        self.inputs['climate']['inject_beam'] = inject_beam
        self.inputs['climate']['beam_profile'] = beam_profile

    def climate(self, opacityclass, **kw):
        """Radiative-convective equilibrium solve (climate/api.py).

        Runs in float64 whatever the process default: the upper
        atmosphere's radiative balance is a small difference of large
        fluxes, and in float32 the solve stalls or settles tens of K away
        from the float64 profile (PERF.md, PR 1)."""
        from .climate.api import run_climate
        with jax.enable_x64(True):
            return run_climate(self, opacityclass, **kw)

    def effective_temp(self, teff=None):
        return self.T_eff(teff)

    def T_eff(self, Teff=None):
        self.inputs['planet']['T_eff'] = Teff if Teff is not None else 0

    # -- run ---------------------------------------------------------------
    def spectrum(self, opacityclass, calculation='reflected',
                 dimension='1d', full_output=False, plot_opacity=False,
                 as_dict=True):
        if self.inputs['star'].get('radius') == 'nostar':
            calculation = 'thermal'
        if self.inputs.get('phase_angle') is None:
            if 'reflected' in calculation:
                raise ValueError('run phase_angle() before a reflected '
                                 'calculation')
            self.phase_angle(0)
        if 'surface_reflect' not in self.inputs:
            self.inputs['surface_reflect'] = 0.0
            self.inputs['hard_surface'] = 0
        return picaso(self, opacityclass, dimension=dimension,
                      calculation=calculation, full_output=full_output,
                      as_dict=as_dict)

    def phase_curve(self, opacityclass, full_output=False, n_cpu=1,
                    verbose=True, batched=None, mesh=None):
        """Phase-curve fan-out (analog of justdoit.py:4741-4777).

        With 1D profiles the phase axis becomes a vmapped batch of ONE
        fused XLA program (optionally sharded over a mesh 'batch' axis)
        instead of the reference's joblib/serial per-phase loop —
        ``batched=None`` auto-selects it whenever the profiles are 1D
        and no patchy clouds are requested.  3D (GCM) phase curves take
        the per-phase path (each phase is already a facet-vmapped
        program).  ``n_cpu`` is accepted for API parity and unused.
        """
        phases = np.atleast_1d(self.inputs['phase_angle'])
        calculation = self.inputs['disco_calculation']
        all_geom = self.inputs['disco']
        all_profiles = self.inputs['atmosphere']['profile']
        all_clds = self.inputs['clouds'].get('profile')

        def _is_1d(p):
            return not (isinstance(p, dict) and 'lat' in p)

        profiles_1d = (_is_1d(all_profiles)
                       if not isinstance(all_profiles, (list, tuple))
                       else all(_is_1d(p) for p in all_profiles))
        if batched is None:
            batched = (profiles_1d
                       and not self.inputs['clouds'].get('do_holes'))
        if batched:
            if not profiles_1d:
                raise ValueError('batched phase curves need 1D profiles')
            return self._phase_curve_batched(
                opacityclass, phases, calculation, all_geom,
                all_profiles, all_clds, mesh=mesh, verbose=verbose)
        out = {}
        for i, iphase in enumerate(phases):
            case = copy.copy(self)
            case.inputs = copy.deepcopy(
                {k: v for k, v in self.inputs.items() if k != 'disco'})
            case.inputs['phase_angle'] = float(iphase)
            case.inputs['disco'] = all_geom[float(iphase)]
            # per-phase (rotated) profiles/clouds are given as sequences
            # (the analog of atmosphere_4d/clouds_4d, justdoit.py:3666)
            if isinstance(all_profiles, (list, tuple)):
                case.inputs['atmosphere']['profile'] = all_profiles[i]
            if isinstance(all_clds, (list, tuple)):
                case.inputs['clouds']['profile'] = all_clds[i]
            if verbose:
                print('Currently computing Phase', iphase)
            prof = case.inputs['atmosphere']['profile']
            dim = ('3d' if isinstance(prof, dict) and 'lat' in prof
                   else '1d')
            out[float(iphase)] = case.spectrum(
                opacityclass, calculation=calculation, dimension=dim,
                full_output=full_output)
        return out

    def _phase_curve_batched(self, opacityclass, phases, calculation,
                             all_geom, all_profiles, all_clds, mesh=None,
                             verbose=True):
        """All phases as ONE batched fused program."""
        import dataclasses as _dc
        from . import pipeline as _pl

        scenes = []
        config = None
        for i, iphase in enumerate(phases):
            case = copy.copy(self)
            case.inputs = copy.copy(self.inputs)
            case.inputs['atmosphere'] = dict(self.inputs['atmosphere'])
            case.inputs['clouds'] = dict(self.inputs['clouds'])
            case.inputs['phase_angle'] = float(iphase)
            case.inputs['disco'] = all_geom[float(iphase)]
            if isinstance(all_profiles, (list, tuple)):
                case.inputs['atmosphere']['profile'] = all_profiles[i]
            if isinstance(all_clds, (list, tuple)):
                case.inputs['clouds']['profile'] = all_clds[i]
            dtype = (np.float64 if jax.config.jax_enable_x64
                     else np.float32)
            scene, config = _pl.scene_from_case(case, opacityclass,
                                                dtype=dtype)
            scenes.append(scene)
        config = _dc.replace(
            config,
            reflected='reflected' in calculation,
            thermal='thermal' in calculation,
            transmission='transmission' in calculation)
        batch = _pl.stack_scenes(scenes)
        if verbose:
            print(f'Batched phase curve: {len(phases)} phases in one '
                  'program')
        if mesh is not None:
            from . import parallel as _par
            res = _par.sharded_forward(
                _par.shard_scene(batch, mesh, batched=True),
                _par.shard_grid(opacityclass.grid, mesh), config, mesh,
                batched=True)
        else:
            res = _pl.forward_batch(batch, opacityclass.grid, config)

        wno = np.asarray(opacityclass.wno)
        sa = self.inputs['star'].get('semi_major', np.nan)
        rp = self.inputs['planet'].get('radius', np.nan)
        out = {}
        for i, iphase in enumerate(phases):
            d = {'wavenumber': wno}
            if 'albedo' in res:
                alb = np.asarray(res['albedo'][i])
                d['albedo'] = alb
                if np.isfinite(sa) and np.isfinite(rp):
                    d['fpfs_reflected'] = alb * (rp / sa) ** 2
            if 'thermal' in res:
                th = np.asarray(res['thermal'][i])
                d['thermal'] = th
                flux_star = opacityclass.unshifted_stellar_spec
                rstar = self.inputs['star'].get('radius')
                if (flux_star is not None
                        and isinstance(rstar, (int, float))
                        and np.isfinite(rstar) and np.isfinite(rp)):
                    d['fpfs_thermal'] = (th / np.asarray(flux_star)
                                         * (rp / rstar) ** 2)
            if 'transit_depth' in res:
                d['transit_depth'] = np.asarray(res['transit_depth'][i])
            out[float(iphase)] = d
        return out


# ---------------------------------------------------------------------------
# orchestration
# ---------------------------------------------------------------------------

def _build_atmosphere_from_inputs(bundle, wno):
    inp = bundle.inputs
    profile = inp['atmosphere']['profile']
    cld = inp['clouds'].get('profile')
    cld_wno = inp['clouds'].get('wavenumber')
    cld_dict = None
    if cld is not None:
        cld_dict = {k: np.asarray(cld[k]) for k in ('opd', 'g0', 'w0')}
    atm = build_atmosphere(
        profile,
        gravity=inp['planet']['gravity'] or np.nan,
        radius=inp['planet']['radius'] if inp['planet']['radius'] else np.nan,
        mass=inp['planet']['mass'] if inp['planet']['mass'] else np.nan,
        p_reference=inp['approx']['p_reference'],
        wno=wno, cld_profile=cld_dict, cld_wno=cld_wno)
    return atm


def _gas_optics(atm: Atmosphere, opa: Opacity, raman_approx, exclude_mol=1):
    """taugas/tauray/raman per gauss point: [ngauss, nlayer, nwno] arrays."""
    nlayer, nwno = atm.nlayer, opa.nwno
    dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32

    # --- molecular + continuum ---
    taugas = jnp.zeros((opa.ngauss, nlayer, nwno), dtype)
    if opa.grid is not None:
        used = [m for m in atm.molecules if m in opa.grid.molecules]
        if used:
            mol_idx = np.array([opa.grid.molecules.index(m) for m in used])
            interp = (interp_molecular
                      if getattr(opa, 'query_method', 'linear') == 'linear'
                      else interp_molecular_nearest)
            kappa = interp(opa.grid, jnp.asarray(atm.t_layer),
                           jnp.asarray(atm.p_layer / PCONV))
            kappa = kappa[mol_idx]
            mix_cols = jnp.asarray(
                np.stack([atm.mixing_ratio_layer(m) for m in used]))
            fac = None
            if isinstance(exclude_mol, dict):
                fac = jnp.asarray([exclude_mol.get(m, 1) for m in used],
                                  dtype)
            tau_mol = assemble.molecular_tau(
                kappa, mix_cols, jnp.asarray(atm.colden),
                jnp.asarray(atm.mmw_layer), fac=fac)
            taugas = taugas + tau_mol[None]
        pairs = atm.continuum_pairs(opa.avail_continuum)
        specs = assemble.classify_continuum(pairs)
        if specs:
            cont = nearest_continuum(opa.grid, jnp.asarray(atm.t_layer))
            cont_kappa = {}
            for s in specs:
                ic = list(opa.grid.continuum_molecules).index(s.name)
                cont_kappa[s.name] = cont[ic]
            coef1 = assemble.amagat_coef1(
                jnp.asarray(atm.temperature),
                jnp.asarray(atm.pressure / PCONV),
                jnp.asarray(atm.t_layer), jnp.asarray(atm.p_layer / PCONV),
                atm.gravity, jnp.asarray(atm.mmw_layer))
            mix = {m: jnp.asarray(atm.mixing_ratio_layer(m))
                   for m in atm.molecules}
            for s in specs:
                for m in (s.mol1, s.mol2):
                    if m and m not in mix:
                        mix[m] = jnp.zeros(nlayer, dtype)
            elec = (jnp.asarray(atm.electrons_layer)
                    if atm.electrons_layer is not None
                    else jnp.zeros(nlayer, dtype))
            tau_cont = assemble.continuum_tau(
                specs, cont_kappa, mix, elec, coef1,
                jnp.asarray(atm.p_layer), jnp.asarray(atm.t_layer),
                jnp.asarray(atm.colden), jnp.asarray(atm.mmw_layer))
            if tau_cont is not None:
                taugas = taugas + tau_cont[None]
    elif opa.ck is not None:
        from .opacities.ck import ck_taugas
        taugas = taugas + ck_taugas(opa.ck, atm)

    # --- rayleigh ---
    ray_species = atm.rayleigh_species(opa.rayleigh_molecules)
    if ray_species:
        sigma = jnp.asarray(
            np.stack([opa.rayleigh_opa[m] for m in ray_species]), dtype)
        mix_ray = jnp.asarray(
            np.stack([atm.mixing_ratio_layer(m) for m in ray_species]))
        tauray = assemble.rayleigh_tau(sigma, mix_ray,
                                       jnp.asarray(atm.colden),
                                       jnp.asarray(atm.mmw_layer))
    else:
        tauray = jnp.zeros((nlayer, nwno), dtype)
    tauray = jnp.broadcast_to(tauray[None], (opa.ngauss, nlayer, nwno))

    # --- raman factor ---
    if raman_approx == 0:
        if opa.raman_stellar_shifts is None:
            raise ValueError("raman='oklopcic' needs star() run first")
        rf = raman_mod.raman_factor_oklopcic(
            jnp.asarray(opa.wno, dtype),
            jnp.asarray(opa.raman_stellar_shifts, dtype),
            jnp.asarray(atm.t_layer),
            jnp.asarray(opa.raman_db['c'].values, dtype),
            jnp.asarray(opa.raman_db['ji'].values, jnp.int32),
            jnp.asarray(opa.raman_db['deltanu'].values, dtype))
        rf = jnp.minimum(rf, 0.99999)
    elif raman_approx == 1:
        rf = jnp.asarray(raman_mod.raman_factor_pollack(
            nlayer, 1e4 / np.asarray(opa.wno),
            refdata_dir=os.path.dirname(
                os.path.dirname(refdata_path('opacities', 'raman.txt')))),
            dtype)
        rf = jnp.minimum(rf, 0.99999)
    else:
        rf = jnp.full((nlayer, nwno), 0.99999, dtype)
    rf = jnp.broadcast_to(rf[None], (opa.ngauss, nlayer, nwno))
    return taugas, tauray, rf


def _cloud_arrays(atm, ngauss, nwno, dtype):
    opd = (jnp.asarray(atm.cld_opd) if atm.cld_opd is not None
           else jnp.zeros((atm.nlayer, nwno)))
    g0 = (jnp.asarray(atm.cld_g0) if atm.cld_g0 is not None
          else jnp.zeros((atm.nlayer, nwno)))
    w0 = (jnp.asarray(atm.cld_w0) if atm.cld_w0 is not None
          else jnp.zeros((atm.nlayer, nwno)))
    bcast = lambda x: jnp.broadcast_to(x[None].astype(dtype),
                                       (ngauss, atm.nlayer, nwno))
    return bcast(opd), bcast(g0), bcast(w0)


def compute_rtprops(bundle, opacityclass, atm, fthin_cld=None,
                    do_holes=False):
    """Atmosphere + opacity -> RTProps [ngauss, ...] (optics.py:26-431)."""
    inp = bundle.inputs
    common = inp['approx']['rt_params']['common']
    raman_approx = common['raman']
    delta_eddington = common['delta_eddington']
    stream = common['stream']
    test_mode = inp.get('test_mode')
    exclude_mol = inp['atmosphere'].get('exclude_mol', 1)

    dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    taugas, tauray, rf = _gas_optics(atm, opacityclass, raman_approx,
                                     exclude_mol)
    taucld, g0_cld, w0_cld = _cloud_arrays(atm, opacityclass.ngauss,
                                           opacityclass.nwno, dtype)
    if do_holes:
        taucld = (fthin_cld if fthin_cld is not None else 0.0) * taucld
    return combine_optics(taugas.astype(dtype), tauray.astype(dtype),
                          taucld, w0_cld, g0_cld, rf.astype(dtype),
                          test_mode=test_mode,
                          delta_eddington=delta_eddington, stream=stream)


def picaso(bundle, opacityclass, dimension='1d', calculation='reflected',
           full_output=False, plot_opacity=False, as_dict=True):
    """Top-level forward model (port of justdoit.py:65-621)."""
    inp = bundle.inputs
    wno = np.asarray(opacityclass.wno)
    nwno = opacityclass.nwno
    ngauss = opacityclass.ngauss
    gauss_wts = jnp.asarray(opacityclass.gauss_wts)

    common = inp['approx']['rt_params']['common']
    tp = inp['approx']['rt_params']['toon']
    frac = common['TTHG_params']['fraction']
    controls = toon.ScatteringControls(
        single_phase=tp['single_phase'], multi_phase=tp['multi_phase'],
        toon_coefficients=tp['toon_coefficients'],
        frac_a=float(frac[0]), frac_b=float(frac[1]), frac_c=float(frac[2]),
        constant_back=float(common['TTHG_params']['constant_back']),
        constant_forward=float(common['TTHG_params']['constant_forward']))
    rt_method = inp['approx']['rt_method']
    get_lvl_flux = bool(inp['approx'].get('get_lvl_flux', False))

    geom: disco_mod.Geometry = inp['disco']
    ubar0 = jnp.asarray(geom.ubar0)
    ubar1 = jnp.asarray(geom.ubar1)
    gweight = jnp.asarray(geom.gweight)
    tweight = jnp.asarray(geom.tweight)
    cos_theta = geom.cos_theta

    radius_star = inp['star'].get('radius')
    if inp['star'].get('database') == 'nostar' or radius_star == 'nostar':
        F0PI = np.zeros(nwno) + 1.0
    else:
        F0PI = np.asarray(opacityclass.relative_flux)
    F0PI = jnp.asarray(F0PI)
    sa = inp['star'].get('semi_major', np.nan)

    surf_reflect = inp.get('surface_reflect', 0.0)
    if isinstance(surf_reflect, (int, float)):
        surf_reflect = np.zeros(nwno) + surf_reflect
    surf_reflect = jnp.asarray(surf_reflect)
    hard_surface = bool(inp.get('hard_surface', 0))

    do_holes = inp['clouds'].get('do_holes', False)
    fhole = inp['clouds'].get('fhole', 0.0) if do_holes else 0.0
    fthin_cld = inp['clouds'].get('fthin_cld') if do_holes else None

    if dimension != '1d':
        from .three_d import picaso_3d
        return picaso_3d(bundle, opacityclass, calculation=calculation,
                         full_output=full_output, as_dict=as_dict)

    atm = _build_atmosphere_from_inputs(bundle, wno)
    atm.surf_reflect = surf_reflect
    props = compute_rtprops(bundle, opacityclass, atm)
    props_clear = (compute_rtprops(bundle, opacityclass, atm,
                                   fthin_cld=fthin_cld, do_holes=True)
                   if do_holes else None)

    returns = {'wavenumber': wno}
    full = {}

    if 'reflected' in calculation:
        def run_reflected(p: RTProps):
            if rt_method == 'SH':
                from .rt.sh import reflected_sh
                sh = inp['approx']['rt_params']['SH']
                return reflected_sh(
                    p, surf_reflect, ubar0, ubar1, cos_theta, F0PI,
                    stream=common['stream'], controls=controls,
                    w_single_form=sh['w_single_form'],
                    w_multi_form=sh['w_multi_form'],
                    psingle_form=sh['psingle_form'],
                    w_single_rayleigh=sh['w_single_rayleigh'],
                    w_multi_rayleigh=sh['w_multi_rayleigh'],
                    psingle_rayleigh=sh['psingle_rayleigh'],
                    single_form=sh['single_form']), None
            return toon.reflected_1d(
                p.dtau, p.tau, p.w0, p.cosb, p.gcos2, p.ftau_cld,
                p.ftau_ray, p.dtau_og, p.tau_og, p.w0_og, p.cosb_og,
                surf_reflect, ubar0, ubar1, cos_theta, F0PI,
                controls=controls, get_toa_intensity=True,
                get_lvl_flux=get_lvl_flux)

        xints = []
        lvls = []
        for ig in range(ngauss):
            xint, lvl = run_reflected(props.slice_gauss(ig))
            if do_holes:
                xint_c, lvl_c = (toon.reflected_1d(
                    *[getattr(props_clear.slice_gauss(ig), f)
                      for f in ('dtau', 'tau', 'w0', 'cosb', 'gcos2',
                                'ftau_cld', 'ftau_ray', 'dtau_og', 'tau_og',
                                'w0_og', 'cosb_og')],
                    surf_reflect, ubar0, ubar1, cos_theta, F0PI,
                    controls=controls, get_toa_intensity=True,
                    get_lvl_flux=get_lvl_flux))
                xint = (1 - fhole) * xint + fhole * xint_c
                if get_lvl_flux:
                    lvl = toon.FluxSet(*((1 - fhole) * a + fhole * b
                                         for a, b in zip(lvl, lvl_c)))
            xints.append(xint)
            lvls.append(lvl)
        xint_at_top = sum(x * gauss_wts[i] for i, x in enumerate(xints))
        albedo = disco_mod.compress_disco(xint_at_top, gweight, tweight,
                                          cos_theta, F0PI)
        returns['albedo'] = np.asarray(albedo)
        if opacityclass.unshifted_stellar_spec is not None:
            spec = np.asarray(opacityclass.unshifted_stellar_spec)
            returns['bond_albedo'] = float(
                np.trapezoid(x=1 / wno, y=np.asarray(albedo) * spec)
                / np.trapezoid(x=1 / wno, y=spec))
        r_planet = atm.radius
        if (not np.isnan(sa)) and (not np.isnan(r_planet)):
            returns['fpfs_reflected'] = np.asarray(
                albedo * (r_planet / sa) ** 2)
        else:
            returns['fpfs_reflected'] = []
        if get_lvl_flux:
            full['lvl_output_reflected'] = _integrate_lvl_fluxes(
                lvls, gauss_wts, gweight, tweight, cos_theta, nwno)
        if full_output:
            full['xint_at_top'] = np.asarray(xint_at_top)

    if 'thermal' in calculation:
        calc_type = 1 if get_lvl_flux else 0
        flux_at_top = 0
        lvl_acc = None
        for ig in range(ngauss):
            p = props.slice_gauss(ig)
            if rt_method == 'SH':
                from .rt.sh import thermal_sh
                flux, _ = thermal_sh(
                    jnp.asarray(atm.temperature), p,
                    jnp.asarray(atm.pressure), ubar1, surf_reflect,
                    jnp.asarray(wno), stream=common['stream'],
                    hard_surface=hard_surface)
                lvl = None
            else:
                flux, lvl = toon.thermal_1d(
                    jnp.asarray(atm.temperature), p.dtau_og, p.w0_no_raman,
                    p.cosb_og, jnp.asarray(atm.pressure), ubar1,
                    surf_reflect, jnp.asarray(wno),
                    dwno=jnp.asarray(getattr(opacityclass, 'delta_wno',
                                             np.zeros(nwno))),
                    hard_surface=hard_surface, calc_type=calc_type)
            if do_holes:
                pc = props_clear.slice_gauss(ig)
                flux_c, lvl_c = toon.thermal_1d(
                    jnp.asarray(atm.temperature), pc.dtau_og, pc.w0_no_raman,
                    pc.cosb_og, jnp.asarray(atm.pressure), ubar1,
                    surf_reflect, jnp.asarray(wno),
                    dwno=jnp.asarray(getattr(opacityclass, 'delta_wno',
                                             np.zeros(nwno))),
                    hard_surface=hard_surface, calc_type=calc_type)
                flux = (1 - fhole) * flux + fhole * flux_c
                if lvl is not None:
                    lvl = toon.FluxSet(*((1 - fhole) * a + fhole * b
                                         for a, b in zip(lvl, lvl_c)))
            flux_at_top = flux_at_top + flux * gauss_wts[ig]
            if get_lvl_flux and lvl is not None:
                if lvl_acc is None:
                    lvl_acc = toon.FluxSet(*(x * gauss_wts[ig] for x in lvl))
                else:
                    lvl_acc = toon.FluxSet(
                        *(a + x * gauss_wts[ig]
                          for a, x in zip(lvl_acc, lvl)))
        thermal = disco_mod.compress_thermal(flux_at_top, gweight, tweight)
        returns['thermal'] = np.asarray(thermal)
        returns['thermal_unit'] = 'erg/s/(cm^2)/(cm)'
        returns['effective_temperature'] = float(
            (np.trapezoid(x=1 / wno[::-1],
                          y=np.asarray(thermal)[::-1]) / SB_SIGMA) ** 0.25)
        if get_lvl_flux and lvl_acc is not None:
            delta_wno = getattr(opacityclass, 'delta_wno',
                                np.concatenate((np.diff(wno),
                                                [np.diff(wno)[-1]])))
            full['lvl_output_thermal'] = {
                k: np.asarray(disco_mod.compress_thermal(
                    v, gweight, tweight)) * delta_wno
                for k, v in lvl_acc._asdict().items()}
        if radius_star == 'nostar':
            returns['fpfs_thermal'] = ['No star mode for Brown Dwarfs '
                                       'was used']
        elif ((not np.isnan(atm.radius))
              and isinstance(radius_star, float)
              and not np.isnan(radius_star)):
            returns['fpfs_thermal'] = np.asarray(
                thermal / np.asarray(opacityclass.unshifted_stellar_spec)
                * (atm.radius / radius_star) ** 2)
        else:
            returns['fpfs_thermal'] = []
        if full_output:
            full['flux_at_top'] = np.asarray(flux_at_top)

    if 'transmission' in calculation:
        rprs2 = 0
        for ig in range(ngauss):
            p = props.slice_gauss(ig)
            r = transit_depth(jnp.asarray(atm.z), jnp.asarray(atm.dz),
                              radius_star, jnp.asarray(atm.mmw_layer),
                              jnp.asarray(atm.pressure),
                              jnp.asarray(atm.temperature),
                              jnp.asarray(atm.colden), p.dtau_og)
            if do_holes:
                pc = props_clear.slice_gauss(ig)
                rc = transit_depth(jnp.asarray(atm.z), jnp.asarray(atm.dz),
                                   radius_star, jnp.asarray(atm.mmw_layer),
                                   jnp.asarray(atm.pressure),
                                   jnp.asarray(atm.temperature),
                                   jnp.asarray(atm.colden), pc.dtau_og)
                r = (1 - fhole) * r + fhole * rc
            rprs2 = rprs2 + r * gauss_wts[ig]
        returns['transit_depth'] = np.asarray(rprs2)

    if (isinstance(returns.get('fpfs_reflected'), np.ndarray)
            and isinstance(returns.get('fpfs_thermal'), np.ndarray)):
        returns['fpfs_total'] = (returns['fpfs_thermal']
                                 + returns['fpfs_reflected'])

    if full_output:
        full['layer'] = {
            'pressure': atm.p_layer / PCONV, 'temperature': atm.t_layer,
            'colden': atm.colden, 'mmw': atm.mmw_layer,
            'column_density': atm.colden,
            'cloud': {'opd': atm.cld_opd, 'g0': atm.cld_g0,
                      'w0': atm.cld_w0}}
        full['level'] = {'pressure': atm.pressure / PCONV,
                         'temperature': atm.temperature,
                         'z': atm.z, 'dz': atm.dz}
        # per-source optical depths in the reference's full-output layout
        # [nlayer, nwno, ngauss] (justdoit.py:518-621 via compute_opacity)
        taugas_d, tauray_d, _rf = _gas_optics(
            atm, opacityclass,
            inp['approx']['rt_params']['common']['raman'],
            inp['atmosphere'].get('exclude_mol', 1))
        full['taugas'] = np.transpose(np.asarray(taugas_d), (1, 2, 0))
        full['tauray'] = np.transpose(np.asarray(tauray_d), (1, 2, 0))
        opd = (np.asarray(atm.cld_opd) if atm.cld_opd is not None
               else np.zeros((atm.nlayer, len(wno))))
        full['taucld'] = np.repeat(opd[:, :, None], opacityclass.ngauss,
                                   axis=2)
        full['wavenumber'] = wno
        full['warnings'] = list(atm.warnings)
        if inp['star'].get('database') != 'nostar' and \
                opacityclass.unshifted_stellar_spec is not None:
            full['star'] = {'flux': np.asarray(
                opacityclass.unshifted_stellar_spec)}
        returns['full_output'] = full if as_dict else atm
    return returns


def _integrate_lvl_fluxes(lvls, gauss_wts, gweight, tweight, cos_theta,
                          nwno):
    acc = None
    for ig, lvl in enumerate(lvls):
        if lvl is None:
            continue
        scaled = toon.FluxSet(*(x * gauss_wts[ig] for x in lvl))
        acc = scaled if acc is None else toon.FluxSet(
            *(a + s for a, s in zip(acc, scaled)))
    if acc is None:
        return None
    ones = jnp.ones(nwno)
    out = {}
    for name, data in acc._asdict().items():
        # integrate each level over the disk (justdoit.py:536-548)
        nlev = data.shape[2]
        out[name] = np.asarray(jnp.stack([
            disco_mod.compress_disco(data[:, :, i, :], gweight, tweight,
                                     cos_theta, ones)
            for i in range(nlev)]))
    return out


# ---------------------------------------------------------------------------
# bundled base cases
# ---------------------------------------------------------------------------

def jupiter_pt():
    return refdata_path('base_cases', 'jupiter.pt')


def jupiter_cld():
    return refdata_path('base_cases', 'jupiterf3.cld')


def HJ_pt():
    return refdata_path('base_cases', 'HJ.pt')


def HJ_cld():
    return refdata_path('base_cases', 'HJ.cld')


def HJ_pt_3d(as_xarray=False, add_kz=False, input_file=None):
    """3D hot-Jupiter PT case file (justdoit.py:5424).  The HJ_3d.pt
    pickle is not bundled (it is absent from the reference distribution
    too); point ``input_file`` at a copy or install it in
    $picaso_refdata/base_cases."""
    import pickle as _pickle
    from .refdata import external_refdata
    if input_file is None:
        ext = external_refdata()
        if ext:
            input_file = os.path.join(ext, 'base_cases', 'HJ_3d.pt')
    if not (input_file and os.path.exists(input_file)):
        raise FileNotFoundError(
            'HJ_3d.pt is not bundled; pass input_file= or install it in '
            '$picaso_refdata/base_cases (see picaso_tpu.data)')
    with open(input_file, 'rb') as f:
        out = _pickle.load(f)
    if add_kz:
        for g in out:
            for t in out[g]:
                out[g][t]['kz'] = out[g][t]['P'] * 0 + 1e10
    if as_xarray:
        raise NotImplementedError(
            'as_xarray conversion of the facet-dict case file is not '
            'supported; pass the dict to inputs.atmosphere_3d directly')
    return out


def w17_data():
    """WASP-17b MIRI transmission spectrum (Grant et al. 2023), bundled
    (justdoit.py:5505).  Read it with picaso_tpu.ncio.read_netcdf."""
    return refdata_path(
        'base_cases',
        'Grant_etal_transmission_spectrum_vfinal_bin0.25_'
        'utc20230606_125313.nc')


def all_planets():
    """All confirmed planets from the NASA Exoplanet Archive
    (justdoit.py:5628; requires network access)."""
    df = get_targets()
    for c in df.columns:
        df[c] = df[c].astype(float, errors='ignore')
    return df


def brown_dwarf_pt():
    return refdata_path('base_cases', 't1270g200f1_m0.0_co1.0.cmp')


def brown_dwarf_cld():
    return refdata_path('base_cases', 't1270g200f1_m0.0_co1.0.cld')


# ---------------------------------------------------------------------------
# contribution functions
# ---------------------------------------------------------------------------

def get_contribution(bundle, opacityclass, at_tau=1, dimension='1d'):
    """Per-species optical-depth contributions (justdoit.py:1090-1295).

    Returns dict with:
      taus_per_layer : {species: [nlayer, nwno]} per-layer optical depth
      cumsum_taus    : {species: [nlevel, nwno]} cumulative from the top
      tau_p_surface  : {species: [nwno]} pressure (bar) where tau = at_tau
    """
    if dimension != '1d':
        raise NotImplementedError('contribution functions are 1d')
    wno = np.asarray(opacityclass.wno)
    atm = _build_atmosphere_from_inputs(bundle, wno)
    taus = {}

    if opacityclass.grid is not None:
        used = [m for m in atm.molecules if m in opacityclass.grid.molecules]
        if used:
            kappa = np.asarray(interp_molecular(
                opacityclass.grid, jnp.asarray(atm.t_layer),
                jnp.asarray(atm.p_layer / PCONV)))
            for m in used:
                im = opacityclass.grid.molecules.index(m)
                taus[m] = (kappa[im]
                           * (atm.mixing_ratio_layer(m) * atm.colden
                              / atm.mmw_layer)[:, None])
        pairs = atm.continuum_pairs(opacityclass.avail_continuum)
        specs = assemble.classify_continuum(pairs)
        if specs:
            cont = np.asarray(nearest_continuum(
                opacityclass.grid, jnp.asarray(atm.t_layer)))
            coef1 = np.asarray(assemble.amagat_coef1(
                jnp.asarray(atm.temperature),
                jnp.asarray(atm.pressure / PCONV),
                jnp.asarray(atm.t_layer), jnp.asarray(atm.p_layer / PCONV),
                atm.gravity, jnp.asarray(atm.mmw_layer)))
            from .constants import AMU, K_B
            for s in specs:
                ic = list(opacityclass.grid.continuum_molecules).index(
                    s.name)
                k = cont[ic]
                if s.kind == 'cia':
                    mix1 = atm.mixing_ratio_layer(s.mol1) \
                        if s.mol1 in atm.molecules else 0
                    mix2 = atm.mixing_ratio_layer(s.mol2) \
                        if s.mol2 in atm.molecules else 0
                    taus[s.name] = k * (coef1 * mix1 * mix2)[:, None]
                elif s.kind == 'H-bf':
                    taus[s.name] = k * (atm.mixing_ratio_layer('H-')
                                        * atm.colden
                                        / (atm.mmw_layer * AMU))[:, None]
                elif s.kind == 'H-ff' and atm.electrons_layer is not None:
                    taus[s.name] = k * (
                        atm.p_layer * atm.mixing_ratio_layer('H')
                        * atm.electrons_layer * atm.colden
                        / (atm.t_layer * atm.mmw_layer * AMU
                           * K_B))[:, None]
                elif s.kind == 'H2-' and atm.electrons_layer is not None:
                    taus[s.name] = k * (
                        atm.p_layer * atm.mixing_ratio_layer('H2')
                        * atm.electrons_layer * atm.colden
                        / (atm.mmw_layer * AMU))[:, None]

    ray_species = atm.rayleigh_species(opacityclass.rayleigh_molecules)
    if ray_species:
        sigma = np.stack([opacityclass.rayleigh_opa[m]
                          for m in ray_species])
        mix_ray = np.stack([atm.mixing_ratio_layer(m) for m in ray_species])
        taus['rayleigh'] = np.einsum(
            'mw,ml->lw', sigma, mix_ray * atm.colden / atm.mmw_layer)

    if atm.cld_opd is not None and np.any(atm.cld_opd):
        taus['cloud'] = np.asarray(atm.cld_opd)

    cumsum_taus = {}
    tau_p_surface = {}
    p_level_bar = atm.pressure / PCONV
    for name, t in taus.items():
        c = np.zeros((atm.nlevel, len(wno)))
        c[1:] = np.cumsum(t, axis=0)
        cumsum_taus[name] = c
        # pressure where cumulative tau crosses at_tau (log-interp)
        press = np.full(len(wno), np.nan)
        for w in range(len(wno)):
            idx = np.searchsorted(c[:, w], at_tau)
            if 0 < idx < atm.nlevel:
                lo, hi = c[idx - 1, w], c[idx, w]
                f = 0.0 if hi == lo else (at_tau - lo) / (hi - lo)
                press[w] = np.exp(np.log(p_level_bar[idx - 1])
                                  + f * np.log(p_level_bar[idx]
                                               / p_level_bar[idx - 1]))
            elif idx >= atm.nlevel:
                press[w] = p_level_bar[-1]
        tau_p_surface[name] = press
    return {'taus_per_layer': taus, 'cumsum_taus': cumsum_taus,
            'tau_p_surface': tau_p_surface}


# ---------------------------------------------------------------------------
# evolution tracks & catalogs (justdoit.py:5536-5658)
# ---------------------------------------------------------------------------

_EVOL_COLS = ['age_years', 'logL', 'R_cm', 'Ts', 'Teff', 'log rc', 'log Pc',
              'log Tc', 'grav_cgs', 'Uth', 'Ugrav', 'log Lnuc']


def evolution_track(mass=1, age='all'):
    """Hot/cold-start evolution tracks for 1-10 Mj planets."""
    valid = np.array([1, 2, 4, 6, 8, 10])
    cols_return = ['age_years', 'Teff', 'grav_cgs', 'logL', 'R_cm']

    def load(start, imass):
        tag = f'00{imass}0'
        if len(tag) == 5:
            tag = tag[1:]
        return pd.read_csv(
            refdata_path('evolution', start, f'model_seq.{tag}'),
            skiprows=12, sep=r'\s+', header=None, names=_EVOL_COLS)

    def at_age(df):
        if isinstance(age, str):
            return df
        return df.iloc[(df['age_years'] - age).abs().argsort()[:1]
                       ].to_dict('records')[0]

    if mass == 'all':
        out = {'hot': {}, 'cold': {}}
        for start in ('hot', 'cold'):
            for imass in valid:
                df = load(f'{start}_start', imass)[cols_return]
                out[start][f'{imass}Mj'] = at_age(df)
        return out
    imass = int(valid[np.argmin(np.abs(valid - mass))])
    return {'hot': at_age(load('hot_start', imass)[cols_return]),
            'cold': at_age(load('cold_start', imass)[cols_return])}


def young_planets():
    """Benchmark young planets (ZJ's compilation; justdoit.py:5640)."""
    return pd.read_csv(refdata_path('evolution', 'benchmarks_age_lbol.csv'),
                       skiprows=12)


# ---------------------------------------------------------------------------
# equilibrium-chemistry grids (Visscher) + Sonora profiles
# ---------------------------------------------------------------------------

def _parse_visscher_grid(filename):
    """Parse a Visscher grid text file (T, log10 P, species columns).

    Handles the '2015_06_1060grid_feh_*' / 'sonora_2121grid_*' layout:
    header line with 'T (K)  P (bar)  <species...>', then rows with
    temperature [K], log10 pressure [bar], abundances.
    """
    with open(filename) as f:
        header = f.readline()
    # species names are the tokens after the two parenthesized units;
    # the 1060 headers write 'T (K)  P (bar)', the 2121 ones 'T(K)  P(bar)'
    for unit in ('T (K)', 'P (bar)', 'T(K)', 'P(bar)'):
        header = header.replace(unit, '')
    species = header.split()
    data = np.loadtxt(filename, skiprows=1)
    df = pd.DataFrame(data[:, 2:], columns=species)
    df['temperature'] = data[:, 0]
    df['pressure'] = 10.0 ** data[:, 1]
    return df


def _decode_grid_float(s):
    """Invert the reference's filename encoding of feh/co values.

    2121 grids use plain floats ('sonora_2121grid_feh-0.3_co0.14.txt');
    1060 grids use str(v).replace('.','').replace('-','m')
    (justdoit.py:3079-3083): '00'->0.0, '025'->0.25, 'm03'->-0.3,
    '15'->1.5 — i.e. the dot was removed after the first digit.
    """
    sign = 1.0
    if s.startswith('m'):
        sign, s = -1.0, s[1:]
    if '.' in s:
        return sign * float(s)
    return sign * float(s[0] + '.' + s[1:])


def _nearest_grid_file(directory, pattern_prefix, log_mh, cto):
    """Pick the grid file nearest in (feh, co) from its filename."""
    import re
    files = [f for f in os.listdir(directory)
             if f.startswith(pattern_prefix)]
    best, best_d = None, np.inf
    for f in files:
        m = re.search(r'feh_?(m?[+-]?[\d.]+)_co_?([\d.]+)', f)
        if not m:
            continue
        try:
            # rstrip the dot the regex grabs from the '.txt' suffix
            feh = _decode_grid_float(m.group(1).lstrip('+').rstrip('.'))
            co = _decode_grid_float(m.group(2).rstrip('.'))
        except ValueError:
            continue
        d = (feh - log_mh) ** 2 + (co - cto) ** 2
        if d < best_d:
            best, best_d = f, d
    if best is None:
        raise FileNotFoundError(
            f'no {pattern_prefix}* chemistry grids in {directory}')
    return os.path.join(directory, best)


class _ChemGridMixin:
    """Chemistry-grid methods bound onto inputs below."""

    def channon_grid_low(self, filename=None):
        """Low-T Visscher equilibrium chemistry on the 1060-style grid
        (justdoit.py sonora chem='low' path)."""
        from . import chemistry as chem_mod
        filename = filename or refdata_path('chemistry',
                                            'visscher_abunds_m+0.0_co1.0')
        table = pd.read_csv(filename, index_col=0)
        grid = chem_mod.chem_grid_from_table(table)
        self._apply_chem_grid(grid)

    def chemeq_visscher_1060(self, cto_relative=1.0, log_mh=0.0):
        """Visscher 1060-grid equilibrium chemistry (justdoit.py:3028).

        ``cto_relative`` is the C/O ratio as a FACTOR of solar (0.458,
        Lodders 2010) — the convention the 1060 grid filenames encode
        (co_05..co_25 = 0.5x..2.5x; justdoit.py:3041).  Grids resolve
        through $picaso_refdata/chemistry/visscher_grid_1060 (full set)
        or the bundled solar-composition file.
        """
        from . import chemistry as chem_mod
        from .refdata import external_refdata
        ext = external_refdata()
        directory = (os.path.join(ext, 'chemistry', 'visscher_grid_1060')
                     if ext else None)
        if directory and os.path.isdir(directory):
            fn = _nearest_grid_file(directory, '2015_06_1060grid',
                                    log_mh, cto_relative)
        else:
            fn = refdata_path('chemistry',
                              '2015_06_1060grid_feh_00_co_10.txt')
        table = _parse_visscher_grid(fn)
        grid = chem_mod.chem_grid_from_table(table)
        self._apply_chem_grid(grid)

    def chemeq_visscher_2121(self, cto_absolute=0.458, log_mh=0.0):
        """Visscher 2121-grid equilibrium chemistry (justdoit.py:2837);
        needs the downloaded visscher_grid_2121 set in $picaso_refdata."""
        from . import chemistry as chem_mod
        from .refdata import external_refdata
        ext = external_refdata()
        directory = (os.path.join(ext, 'chemistry', 'visscher_grid_2121')
                     if ext else None)
        if not (directory and os.path.isdir(directory)):
            raise FileNotFoundError(
                'the 2121-point Visscher grids are not bundled; set '
                'picaso_refdata to a directory containing '
                'chemistry/visscher_grid_2121 (see picaso_tpu.data)')
        fn = _nearest_grid_file(directory, 'sonora_2121grid', log_mh,
                                cto_absolute)
        table = _parse_visscher_grid(fn)
        grid = chem_mod.chem_grid_from_table(table)
        self._apply_chem_grid(grid)

    def _chem_3d_apply(self, grid):
        """Post-process chemistry onto a 3D GCM dict in ONE vectorized
        interpolation call (every column flattened into the batch axis) —
        the batched analog of the reference's joblib column fan-out
        (justdoit.py:3560-3633)."""
        from . import chemistry as chem_mod
        data = self.inputs['atmosphere']['profile']
        if not (isinstance(data, dict) and 'lat' in data):
            raise ValueError('premix_3d/chemeq_3d need a 3D GCM dict '
                             '(run atmosphere_3d first)')
        t = np.asarray(data['temperature'], float)   # [nlevel, nlon, nlat]
        nlevel, nlon, nlat = t.shape
        p = np.asarray(data['pressure'], float)
        p_full = np.broadcast_to(p[:, None, None], t.shape)
        abunds = np.asarray(chem_mod.chem_interp(
            grid, jnp.asarray(t.ravel()), jnp.asarray(p_full.ravel())))
        out = dict(data)
        for i, sp in enumerate(grid.species):
            out[sp] = abunds[:, i].reshape(nlevel, nlon, nlat)
        self.inputs['atmosphere']['profile'] = out
        self.nlevel = nlevel
        return out

    def premix_3d(self, opa, n_cpu=1):
        """Premixed CK chemistry on every 3D column (justdoit.py:3517).

        ``n_cpu`` is accepted for API parity but unused: the columns are
        one flattened device batch, not joblib processes."""
        from . import chemistry as chem_mod
        table = (opa.ck.full_abunds
                 if getattr(opa, 'ck', None) is not None else None)
        if table is None:
            raise ValueError('premix_3d needs a CK connection with a '
                             'full_abunds chemistry table')
        return self._chem_3d_apply(chem_mod.chem_grid_from_table(table))

    def chemeq_3d(self, c_o=None, log_mh=0.0, cto_absolute=0.55, n_cpu=1):
        """Visscher equilibrium chemistry on every 3D column
        (justdoit.py:3590); same grid-file resolution as
        chemeq_visscher_1060 (external set or bundled solar file).

        The 1060 grid filenames encode C/O RELATIVE to solar, so the
        absolute input converts via the reference's solar value 0.55
        (justdoit.py:3608); ``c_o`` is already the relative factor.
        """
        from . import chemistry as chem_mod
        from .refdata import external_refdata
        if isinstance(c_o, (int, float)):
            cto_relative = float(c_o)
        else:
            cto_relative = float(cto_absolute) / 0.55
        ext = external_refdata()
        directory = (os.path.join(ext, 'chemistry', 'visscher_grid_1060')
                     if ext else None)
        if directory and os.path.isdir(directory):
            fn = _nearest_grid_file(directory, '2015_06_1060grid',
                                    log_mh, cto_relative)
        else:
            fn = refdata_path('chemistry',
                              '2015_06_1060grid_feh_00_co_10.txt')
        table = _parse_visscher_grid(fn)
        return self._chem_3d_apply(chem_mod.chem_grid_from_table(table))

    def _apply_chem_grid(self, grid):
        from . import chemistry as chem_mod
        prof = self.inputs['atmosphere']['profile']
        abunds = np.asarray(chem_mod.chem_interp(
            grid, jnp.asarray(np.asarray(prof['temperature'], float)),
            jnp.asarray(np.asarray(prof['pressure'], float))))
        out = pd.DataFrame({'pressure': np.asarray(prof['pressure']),
                            'temperature': np.asarray(prof['temperature'])})
        for i, sp in enumerate(grid.species):
            out[sp] = abunds[:, i]
        self.inputs['atmosphere']['profile'] = out
        self.nlevel = out.shape[0]
        return out

    def sonora_profile(self, sonora_path, teff, chem='low'):
        """Load the nearest Sonora Bobcat PT profile (justdoit.py:2759).

        Accepts directories of .cmp.gz or .dat structure files from the
        Bobcat Zenodo releases; gravity must already be set.
        """
        import math as _math
        g = self.inputs['planet']['gravity'] / 100.0
        flist = [i for i in os.listdir(sonora_path) if i[:2] != '._']
        if any('cmp.gz' in f for f in flist):
            flist = [f for f in flist if 'gz' in f]
            suffix = 'nc' + flist[0].split('nc')[-1]
            pairs = [(f, float(f.split('g')[0][1:]),
                      float(f.split('g')[1].split('nc')[0]))
                     for f in flist]
            best = min(pairs, key=lambda c: _math.hypot(c[1] - teff,
                                                        c[2] - g))[0]
            ptchem = pd.read_csv(os.path.join(sonora_path, best),
                                 sep=r'\s+', compression='gzip')
            ptchem = ptchem.rename(columns={'P(BARS)': 'pressure',
                                            'TEMP': 'temperature',
                                            'HE': 'He'})
            self.inputs['atmosphere']['profile'] = ptchem.loc[
                :, ['pressure', 'temperature']]
            self.nlevel = ptchem.shape[0]
        elif any(f.endswith('.dat') for f in flist):
            flist = [f for f in flist if f.endswith('.dat')]
            pairs = [(f, float(f.split('g')[0][1:]),
                      float(f.split('g')[1].split('nc')[0]))
                     for f in flist]
            best = min(pairs, key=lambda c: _math.hypot(c[1] - teff,
                                                        c[2] - g))[0]
            pressure, temp = np.loadtxt(os.path.join(sonora_path, best),
                                        usecols=[1, 2], unpack=True,
                                        skiprows=1)
            self.add_pt(temp, pressure)
        else:
            raise FileNotFoundError(
                f'no .cmp.gz or .dat Sonora structure files in '
                f'{sonora_path}')
        if chem == 'low':
            self.channon_grid_low()
        elif chem == 'grid':
            # reference (justdoit.py:2833) runs the 2121 bobcat grid at
            # solar; fall back to the bundled solar 1060 file when the
            # downloaded 2121 set is absent
            try:
                self.chemeq_visscher_2121(cto_absolute=0.458, log_mh=0.0)
            except FileNotFoundError:
                self.chemeq_visscher_1060(cto_relative=1.0, log_mh=0.0)


# bind the chemistry-grid methods onto inputs
for _name in ('channon_grid_low', 'chemeq_visscher_1060',
              'chemeq_visscher_2121', '_apply_chem_grid',
              '_chem_3d_apply', 'premix_3d', 'chemeq_3d',
              'sonora_profile'):
    setattr(inputs, _name, getattr(_ChemGridMixin, _name))
inputs.sonora = _ChemGridMixin.sonora_profile


def get_targets():
    """All confirmed planets from the NASA Exoplanet Archive
    (justdoit.py:5283; requires network access)."""
    url = ('https://exoplanetarchive.ipac.caltech.edu/TAP/sync?query='
           'select+*+from+PSCompPars&format=csv')
    return pd.read_csv(url)


def load_planet(name, opacity, **kwargs):
    """Build an inputs bundle from archive parameters for one planet
    (justdoit.py:5296)."""
    df = get_targets()
    row = df[df['pl_name'].str.strip() == name]
    if len(row) == 0:
        raise ValueError(f'{name} not found in the exoplanet archive')
    row = row.iloc[0]
    case = inputs()
    case.phase_angle(0)
    case.gravity(radius=float(row['pl_radj']), radius_unit=u.Unit('Rjup'),
                 mass=float(row['pl_bmassj']), mass_unit=u.Unit('Mjup'))
    case.star(opacity, float(row['st_teff']), float(row.get('st_met', 0.0)
                                                    or 0.0),
              float(row['st_logg']), radius=float(row['st_rad']),
              radius_unit=u.Unit('Rsun'),
              semi_major=float(row['pl_orbsmax']),
              semi_major_unit=u.Unit('au'))
    return case


def convert_flux_units(xgrid, flux, to_f_unit, xgrid_unit='cm^(-1)',
                       f_unit='erg*cm^(-3)*s^(-1)'):
    """Convert spectral flux density between common units.

    Self-contained port of justdoit.py:5660-5688 (the reference goes
    through synphot's SourceSpectrum; here the F_lambda/F_nu algebra is
    done directly).  Defaults are PICASO's native per-cm flux on a
    wavenumber grid.  Like the reference, the output is ordered by
    increasing wavelength (flipped when the input was an increasing
    wavenumber grid).

    Supported flux units: 'erg*cm^(-3)*s^(-1)' (per cm), 'FLAM'
    (erg/cm^2/s/angstrom), 'FNU' (erg/cm^2/s/Hz), 'Jy', 'mJy',
    'W/(m2 um)'.
    """
    from .constants import C_LIGHT
    xgrid = np.asarray(xgrid, float)
    flux = np.asarray(flux, float)
    if xgrid_unit in ('cm^(-1)', '1/cm', 'cm-1', '1 / cm'):
        lam_cm = 1.0 / xgrid
    else:
        lam_cm = xgrid * u.Unit(xgrid_unit).cgs_factor

    def norm(name):
        key = str(name).replace(' ', '').lower()
        aliases = {
            'erg*cm^(-3)*s^(-1)': 'per_cm', 'erg/(cm3s)': 'per_cm',
            'erg/(cm2scm)': 'per_cm',
            'flam': 'flam', 'erg/(cm2sangstrom)': 'flam',
            'erg/(cm2saa)': 'flam',
            'fnu': 'fnu', 'erg/(cm2shz)': 'fnu',
            'jy': 'jy', 'mjy': 'mjy',
            'w/(m2um)': 'w_m2_um', 'w/(m2micron)': 'w_m2_um',
        }
        if key not in aliases:
            raise ValueError(f'unsupported flux unit {name!r}; supported: '
                             f'{sorted(set(aliases))}')
        return aliases[key]

    # to F_lambda in erg/cm^2/s/cm
    kind = norm(f_unit)
    if kind == 'per_cm':
        f_lam = flux
    elif kind == 'flam':
        f_lam = flux * 1e8
    elif kind in ('fnu', 'jy', 'mjy'):
        f_nu = flux * {'fnu': 1.0, 'jy': 1e-23, 'mjy': 1e-26}[kind]
        f_lam = f_nu * C_LIGHT / lam_cm ** 2
    else:  # w_m2_um
        f_lam = flux / 1e-7

    kind = norm(to_f_unit)
    if kind == 'per_cm':
        out = f_lam
    elif kind == 'flam':
        out = f_lam * 1e-8
    elif kind in ('fnu', 'jy', 'mjy'):
        f_nu = f_lam * lam_cm ** 2 / C_LIGHT
        out = f_nu / {'fnu': 1.0, 'jy': 1e-23, 'mjy': 1e-26}[kind]
    else:  # w_m2_um
        out = f_lam * 1e-7

    if xgrid_unit in ('cm^(-1)', '1/cm', 'cm-1', '1 / cm') \
            and xgrid[1] > xgrid[0]:
        out = out[::-1]
    return out


def output_xarray(df, case, add_output=None, savefile=None, **kwargs):
    """Persist a computed model (parity name for justdoit.py:705).

    xarray/netcdf is not part of this build's dependency set, so models
    round-trip through the self-describing HDF5 layout of
    io_utils.save_model instead (same content: spectra, profile, clouds,
    planet/star attributes, free-form metadata).  Returns the file path.
    """
    from .io_utils import save_model
    if savefile is None:
        raise ValueError('give savefile= path for the stored model')
    return save_model(savefile, case, df, meta=add_output or {})


def check_units(unit):
    """Return u.Unit(unit) if parseable, else None (justdoit.py:657)."""
    try:
        return u.Unit(unit)
    except ValueError:
        return None


def find_press(at_tau, a, b, c):
    """Pressure where the cumulative tau column crosses ``at_tau``
    (justdoit.py:1290: per-wavelength interp of the [nlayer, nwno] tau
    matrix ``a`` onto pressures ``c``).  ``b`` is nwno, kept for call
    compatibility."""
    a = np.asarray(a)
    c = np.asarray(c)
    return [float(np.interp(at_tau, a[:, iw], c)) for iw in range(b)]


def merge_xarrays(ds1, ds2):
    """Merge two spectrum output dicts that differ only in wavelength
    coverage — e.g. the same model run against two opacity files for two
    bands (parity for justdoit.py:664 merge_xarrays, which does this on
    the xarray outputs).  Wavelength-axis arrays (anything shaped like
    'wavenumber') are concatenated and sorted by wavenumber with ds1
    winning on overlap; every non-spectral key comes from ds1.
    """
    if 'wavenumber' not in ds1 or 'wavenumber' not in ds2:
        raise ValueError("both outputs need a 'wavenumber' axis")
    w1 = np.asarray(ds1['wavenumber'], np.float64)
    w2 = np.asarray(ds2['wavenumber'], np.float64)
    keep2 = ~np.isin(w2, w1)
    wno = np.concatenate([w1, w2[keep2]])
    order = np.argsort(wno)
    merged = dict(ds1)
    merged['wavenumber'] = wno[order]
    for key, v1 in ds1.items():
        if key == 'wavenumber' or not isinstance(v1, np.ndarray):
            continue
        v2 = ds2.get(key)
        if v1.shape[-1:] == w1.shape and isinstance(v2, np.ndarray) \
                and v2.shape[-1:] == w2.shape:
            cat = np.concatenate([v1, v2[..., keep2]], axis=-1)
            merged[key] = cat[..., order]
    return merged


def input_xarray(filename, opannection=None, **kwargs):
    """Rebuild an inputs bundle from a stored model (justdoit.py:979).

    Counterpart of output_xarray; accepts the HDF5 files written by
    io_utils.save_model and returns (case, stored_spectra).
    """
    from .io_utils import load_model
    return load_model(filename, opannection=opannection)
