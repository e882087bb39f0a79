"""Climate orchestration: profile iteration, convective-zone search, user API.

Port of the host-side control flow of the reference (climate.py:126-330
workflows, :2542-2839 ``find_strat``, :2926-3249 ``profile``) around the
jitted device core.  The data-dependent zone bookkeeping stays host Python (a
handful of ints per iteration); everything touching [nlayer, nwno, ngauss]
arrays is device work.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
import jax.numpy as jnp
import pandas as pd

from .. import chemistry
from ..atmosphere import build_atmosphere
from ..constants import PCONV
from ..opacities import assemble
from ..opacities.ck import CKTable, ck_continuum, interp_premix
from ..optics import combine_optics
from ..rt import toon
from . import core
from .adiabat import load_adiabat_grid

__all__ = ['inputs_climate', 'run_climate', 'ck_rtprops']


def ck_rtprops(profile_df, ck: CKTable, gravity, p_reference=1.0,
               delta_eddington=True, stream=2, raman=2,
               cld=None, dtype=np.float64, molecular_kappa_fn=None):
    """Atmosphere + premixed CK table -> RTProps [ngauss, nlayer, nwno].

    The climate analog of calculate_atm (climate.py:1969-2134): premixed
    molecular kappa (no mixing-ratio weighting, optics.py:257-262) +
    CIA continuum + Rayleigh + optional clouds, fused by combine_optics.
    """
    wno = np.asarray(ck.wno)
    nwno = len(wno)
    atm = build_atmosphere(profile_df, gravity=gravity,
                           p_reference=p_reference, wno=wno,
                           cld_profile=cld, cld_wno=None if cld is None
                           else wno)
    nlayer = atm.nlayer

    if molecular_kappa_fn is not None:
        kappa = molecular_kappa_fn(atm)
    else:
        kappa = interp_premix(ck.arrays, jnp.asarray(atm.t_layer),
                              jnp.asarray(atm.p_layer / PCONV))
    # [nlayer, nwno, ngauss] -> [ngauss, nlayer, nwno]
    taugas = (kappa * (atm.colden / atm.mmw_layer)[:, None, None]
              ).transpose(2, 0, 1)

    pairs = atm.continuum_pairs(ck.continuum_molecules)
    specs = assemble.classify_continuum(pairs)
    if specs:
        cont = ck_continuum(ck.arrays, jnp.asarray(atm.t_layer))
        cont_kappa = {s.name: cont[list(ck.continuum_molecules).index(s.name)]
                      for s in specs}
        coef1 = assemble.amagat_coef1(
            jnp.asarray(atm.temperature), jnp.asarray(atm.pressure / PCONV),
            jnp.asarray(atm.t_layer), jnp.asarray(atm.p_layer / PCONV),
            atm.gravity, jnp.asarray(atm.mmw_layer))
        mix = {m: jnp.asarray(atm.mixing_ratio_layer(m))
               for m in atm.molecules}
        for s in specs:
            for m in (s.mol1, s.mol2):
                if m and m not in mix:
                    mix[m] = jnp.zeros(nlayer)
        elec = (jnp.asarray(atm.electrons_layer)
                if atm.electrons_layer is not None else jnp.zeros(nlayer))
        tau_cont = assemble.continuum_tau(
            specs, cont_kappa, mix, elec, coef1, jnp.asarray(atm.p_layer),
            jnp.asarray(atm.t_layer), jnp.asarray(atm.colden),
            jnp.asarray(atm.mmw_layer))
        taugas = taugas + tau_cont[None]

    from ..rayleigh import rayleigh_sigma_table, RAYLEIGH_MOLECULES
    ray_species = atm.rayleigh_species(RAYLEIGH_MOLECULES)
    if ray_species:
        sig = rayleigh_sigma_table(wno, ray_species)
        sigma = jnp.asarray(np.stack([sig[m] for m in ray_species]))
        mix_ray = jnp.asarray(np.stack([atm.mixing_ratio_layer(m)
                                        for m in ray_species]))
        tauray = assemble.rayleigh_tau(sigma, mix_ray,
                                       jnp.asarray(atm.colden),
                                       jnp.asarray(atm.mmw_layer))
    else:
        tauray = jnp.zeros((nlayer, nwno))
    ngauss = ck.ngauss
    tauray = jnp.broadcast_to(tauray[None], (ngauss, nlayer, nwno))

    zeros = jnp.zeros((nlayer, nwno))
    opd = jnp.asarray(atm.cld_opd) if atm.cld_opd is not None else zeros
    g0 = jnp.asarray(atm.cld_g0) if atm.cld_g0 is not None else zeros
    w0 = jnp.asarray(atm.cld_w0) if atm.cld_w0 is not None else zeros
    bc = lambda x: jnp.broadcast_to(x[None], (ngauss, nlayer, nwno))

    rf = jnp.full((ngauss, nlayer, nwno), 0.99999)  # raman off in climate
    props = combine_optics(taugas.astype(dtype), tauray.astype(dtype),
                           bc(opd).astype(dtype), bc(w0).astype(dtype),
                           bc(g0).astype(dtype), rf.astype(dtype),
                           test_mode=None, delta_eddington=delta_eddington,
                           stream=stream)
    return props, atm


class _ClimateState:
    """Everything profile()/find_strat() thread through iterations."""

    def __init__(self, bundle, opacityclass, tidal, rfaci, rfacv, tmin,
                 tmax, moist=False, verbose=True):
        self.bundle = bundle
        self.opa = opacityclass
        self.ck: CKTable = opacityclass.ck
        self.chem_grid = chemistry.chem_grid_from_table(self.ck.full_abunds)
        self.adiabat = load_adiabat_grid()
        self.geom = core.make_climate_geometry()
        self.tidal = tidal
        self.rfaci = rfaci
        self.rfacv = rfacv
        self.tmin = tmin
        self.tmax = tmax
        self.moist = moist
        self.verbose = verbose
        self.wno = jnp.asarray(self.ck.wno)
        self.dwno = jnp.asarray(self.ck.delta_wno)
        self.gauss_wts = jnp.asarray(self.ck.gauss_wts)
        self.surf_reflect = jnp.zeros(len(self.ck.wno))
        self.gravity = bundle.inputs['planet']['gravity']
        common = bundle.inputs['approx']['rt_params']['common']
        tp = bundle.inputs['approx']['rt_params']['toon']
        frac = common['TTHG_params']['fraction']
        self.controls = toon.ScatteringControls(
            single_phase=tp['single_phase'], multi_phase=tp['multi_phase'],
            toon_coefficients=tp['toon_coefficients'],
            frac_a=float(frac[0]), frac_b=float(frac[1]),
            frac_c=float(frac[2]),
            constant_back=float(common['TTHG_params']['constant_back']),
            constant_forward=float(
                common['TTHG_params']['constant_forward']))
        self.F0PI = jnp.asarray(
            opacityclass.relative_flux if opacityclass.relative_flux
            is not None else np.ones(len(self.ck.wno)))
        self.all_profiles = []
        self.runlog = None   # optional profiling.RunLog (SURVEY §5)
        # 4-deep cloud OPD/W0/G0 history (climate.py:2882-2915): the RT
        # sees the EQUAL-WEIGHT AVERAGE of the last 4 virga results, which
        # damps cloud-feedback oscillation, and the taudif convergence
        # gate compares consecutive averages.  Lazy-init on first
        # update_clouds (shape [nlayer, nwave_cld, 4], zeros — the
        # reference ramps the cloud in at 1/4, 1/2, 3/4 strength)
        self.cld_hist = None
        self.last_taudif = 0.0
        self.last_taudif_tol = 1.0

        # --- static + traced state for the fused single-dispatch path ---
        from .. import molmass
        from ..rayleigh import rayleigh_sigma_table, RAYLEIGH_MOLECULES
        from . import fused

        species = self.chem_grid.species
        weights = tuple(molmass.molecular_weight(s) for s in species)
        # continuum pair matching on the chem species (atmsetup.py:248-277),
        # INCLUDING the special H-bf / H-ff / H2- continua the host path
        # builds via Atmosphere.continuum_pairs — dominant opacity for
        # hot (Teff >~ 2500 K) models
        avail = self.ck.continuum_molecules
        pairs = []
        for m1 in species:
            for m2 in species:
                if m1 + m2 in avail:
                    pairs.append((m1, m2))
        if 'H-' in species and 'H-bf' in avail:
            pairs.append(('H-', 'bf'))
        if 'H' in species and 'e-' in species and 'H-ff' in avail:
            pairs.append(('H-', 'ff'))
        if 'H2' in species and 'e-' in species and 'H2-' in avail:
            pairs.append(('H2-', ''))
        specs = tuple(assemble.classify_continuum(pairs))
        cont_indices = tuple(
            list(self.ck.continuum_molecules).index(s.name) for s in specs)
        ray_species = [s for s in species if s in RAYLEIGH_MOLECULES]
        ray_rows = tuple(species.index(s) for s in ray_species)
        wno_np = np.asarray(self.ck.wno)
        sig = rayleigh_sigma_table(wno_np, ray_species)
        sigma_ray = (np.stack([sig[s] for s in ray_species])
                     if ray_species else np.zeros((0, len(wno_np))))

        nlevel = len(bundle.inputs['climate']['pressure'])
        nlayer = nlevel - 1
        nwno = len(wno_np)
        from .moist import COND_CONSTANTS
        condensables = (tuple(c for c in species if c in COND_CONSTANTS)
                        if moist else ())
        cond_weights = tuple(molmass.molecular_weight(c)
                             for c in condensables)
        self.condensables = condensables
        self._config_base = dict(
            species=species, weights=weights, continuum_specs=specs,
            cont_indices=cont_indices, ray_species_rows=ray_rows,
            controls=self.controls,
            delta_eddington=common['delta_eddington'],
            stream=common['stream'], compute_reflected=(rfacv != 0.0),
            moist=bool(moist and condensables), condensables=condensables,
            cond_weights=cond_weights)
        # host-driven workflow flags (set by run_climate)
        self.diseq = False
        self.cloudy = False
        self.self_consistent_kzz = True
        self.virga_kwargs = {}
        self.last_fluxes = None
        self.data = fused.ClimateData(
            plevel=jnp.asarray(
                np.asarray(bundle.inputs['climate']['pressure']) * PCONV),
            gravity=jnp.asarray(float(self.gravity)),
            tidal=jnp.asarray(tidal), rfaci=jnp.asarray(float(rfaci)),
            rfacv=jnp.asarray(float(rfacv)), tmin=jnp.asarray(float(tmin)),
            tmax=jnp.asarray(float(tmax)), F0PI=self.F0PI,
            surf_reflect=self.surf_reflect,
            sigma_ray=jnp.asarray(sigma_ray),
            cld_opd=jnp.zeros((nlayer, nwno)),
            cld_g0=jnp.zeros((nlayer, nwno)),
            cld_w0=jnp.zeros((nlayer, nwno)),
            cond_abunds=jnp.zeros((nlayer, max(len(condensables), 1))),
            it_max=jnp.asarray(10, jnp.int32),
            egp_stepmax=jnp.asarray(False))

    def fused_config(self, it_max, egp_stepmax):
        """The static config is knob-free: it_max/egp_stepmax ride in
        ClimateData as traced scalars so per-call changes (it_max 10 vs
        8, the 250 K egp flip) reuse ONE compiled program."""
        from . import fused
        self.data = self.data._replace(
            it_max=jnp.asarray(int(it_max), jnp.int32),
            egp_stepmax=jnp.asarray(bool(egp_stepmax)))
        return fused.ClimateConfig(**self._config_base)

    def premix(self, temp, pressure_bar):
        """Equilibrium-chemistry refresh at the current T(P)."""
        abunds = np.asarray(chemistry.chem_interp(
            self.chem_grid, jnp.asarray(temp), jnp.asarray(pressure_bar)))
        df = pd.DataFrame({'pressure': pressure_bar, 'temperature': temp})
        for i, sp in enumerate(self.chem_grid.species):
            df[sp] = abunds[:, i]
        self.bundle.inputs['atmosphere']['profile'] = df
        return df

    def opacities(self, profile_df):
        common = self.bundle.inputs['approx']['rt_params']['common']
        return ck_rtprops(profile_df, self.ck, self.gravity,
                          p_reference=self.bundle.inputs['approx']
                          ['p_reference'],
                          delta_eddington=common['delta_eddington'],
                          stream=common['stream'])

    # ---- host-assembled path (diseq chemistry / virga clouds) -------------
    def update_diseq_chem(self, temp, pressure_bar):
        """Kzz -> quench levels -> chemistry adjustments (climate.py:
        3083-3109 semantics), returning the adjusted profile df."""
        from . import kzz as kzz_mod

        df = self.premix(temp, pressure_bar)
        grav_si = float(self.gravity) / 100.0
        mmw_layer = self._mmw_layer(df)
        dtdp = np.diff(np.log(temp)) / np.diff(np.log(pressure_bar))
        if self.self_consistent_kzz and self.last_fluxes is not None:
            fnil, fpit = self.last_fluxes
            kz = kzz_mod.get_kzz(pressure_bar, temp, grav_si,
                                 np.asarray(self.tidal), fnil, fpit,
                                 self.adiabat, self.last_nstr, mmw_layer,
                                 dtdp)
        else:
            kz = self.bundle.find_kzz()
            if kz is None:
                kz = np.zeros(len(temp)) + 1e9
        self.bundle.inputs['atmosphere'].setdefault('kzz', {})
        self.bundle.inputs['atmosphere']['kzz']['sc_kzz'] = kz

        scale_h = (1.38e-16 * temp[:-1]
                   / (mmw_layer * 1.66e-24 * float(self.gravity)))
        qlv, _ = chemistry.quench_levels(
            pressure_bar, temp, dtdp, kz, mmw_layer, scale_h, grav_si,
            x_h2o=np.asarray(df.get('H2O', pd.Series(np.zeros(len(temp))))),
            x_h2=np.asarray(df.get('H2', pd.Series(np.ones(len(temp))))),
            strict=False)
        chem_params = self.bundle.inputs['approx'].get('chem_params', {})
        if self.bundle.inputs['climate'].get('pc') is not None:
            # full kinetics: photochem steady state each iteration,
            # quench-adjusted initial guess (climate.py:3107-3109)
            return self.bundle.premix_atmosphere_photochem(
                quench_levels=qlv)
        self.bundle.adjust_quench_chemistry(qlv)
        if chem_params.get('vol_rainout'):
            self.bundle.volatile_rainout(qlv)
        if chem_params.get('cold_trap'):
            self.bundle.cold_trap()
        return self.bundle.inputs['atmosphere']['profile']

    def update_clouds(self, temp, pressure_bar):
        """virga microphysics at the current structure (climate.py:
        2842-2925 semantics); returns a .cld dataframe."""
        from .. import virga as vj
        kz = self.bundle.inputs['atmosphere'].get('kzz', {}).get('sc_kzz')
        if kz is None:
            kz = np.zeros(len(temp)) + 1e9
        ptk = pd.DataFrame({'pressure': pressure_bar, 'temperature': temp,
                            'kz': np.asarray(kz)[:len(temp)]})
        vkw = dict(self.virga_kwargs)
        directory = vkw.pop('directory', None)
        condensates = vkw.pop('condensates', None) or vj.recommend_gas(
            pressure_bar, temp, mh=vkw.get('mh', 1.0),
            mmw=vkw.get('mmw', 2.2))
        atmo = vj.Atmosphere(condensates, **{k: v for k, v in vkw.items()
                                             if k in ('fsed', 'mh', 'mmw',
                                                      'sig', 'b', 'eps',
                                                      'param', 'supsat',
                                                      'gas_mmr')})
        atmo.gravity = float(self.gravity)
        atmo.ptk(df=ptk, kz_min=vkw.get('kz_min', 1e5),
                 alpha_pressure=vkw.get('alpha_pressure'))
        out = vj.compute(atmo, directory=directory,
                         do_virtual=vkw.get('do_virtual', False))
        # 4-step history average (climate.py:2885-2907): shift, insert,
        # average OPD with equal weights; W0/G0 are OPD-weighted means
        opd_now = np.asarray(out['opd_per_layer'], float)
        w0_now = np.asarray(out['single_scattering'], float)
        g0_now = np.asarray(out['asymmetry'], float)
        if self.cld_hist is None or self.cld_hist[0].shape[:2] != \
                opd_now.shape:
            self.cld_hist = [np.zeros(opd_now.shape + (4,))
                             for _ in range(3)]
        opd_h, g0_h, w0_h = self.cld_hist
        opd_prev_step = opd_h.mean(axis=2)
        for a in (opd_h, g0_h, w0_h):
            a[:, :, 1:] = a[:, :, :3]
        opd_h[:, :, 0], g0_h[:, :, 0], w0_h[:, :, 0] = opd_now, g0_now, \
            w0_now
        opd_avg = opd_h.mean(axis=2)
        with np.errstate(invalid='ignore', divide='ignore'):
            g0_avg = np.nan_to_num(
                (opd_h * g0_h).mean(axis=2) / opd_avg, nan=0.0)
            w0_avg = np.nan_to_num(
                (opd_h * w0_h).mean(axis=2) / opd_avg, nan=0.0)
        opd_avg = np.where(opd_avg <= 1e-5, 0.0, opd_avg)
        self.last_taudif = float(np.max(np.abs(opd_avg - opd_prev_step)))
        self.last_taudif_tol = float(
            0.4 * np.max(0.5 * (opd_avg + opd_prev_step)))
        # carry the solver's wave grid so build_props_host regrids from
        # the TRUE source coordinates (mieff grids need not be 196-pt)
        return vj.picaso_format(opd_avg, w0_avg, g0_avg,
                                wavenumber=1e4 / out['wave']), out

    def _mmw_layer(self, df):
        from .. import molmass
        cols = [c for c in df.keys()
                if c not in ('pressure', 'temperature', 'kz', 'e-')]
        w = np.array([molmass.molecular_weight(c) for c in cols])
        mix = df[cols].values
        mmw = mix @ w
        return 0.5 * (mmw[1:] + mmw[:-1])

    def build_props_host(self, profile_df, cld_df=None):
        """RTProps from the CURRENT bundle chemistry: resort-rebin per-gas
        CK mixing when available (diseq), else premixed; optional clouds
        regridded onto the CK wavenumber grid."""
        from ..opacities import resortrebin as rr
        from ..wavelength import get_cld_input_grid, regrid as regrid_rows

        cld = None
        if cld_df is not None:
            nlayer = len(profile_df['pressure']) - 1
            wno = np.asarray(self.ck.wno)
            cld = {}
            if 'wavenumber' in cld_df:
                src_wno = np.reshape(np.asarray(cld_df['wavenumber']),
                                     (nlayer, -1))[0]
            else:
                src_wno = get_cld_input_grid()
            for k in ('opd', 'g0', 'w0'):
                m = np.reshape(np.asarray(cld_df[k]), (nlayer, -1))
                if m.shape[1] != len(wno) or not np.allclose(
                        src_wno, wno):
                    m = regrid_rows(m, src_wno, wno)
                cld[k] = m.ravel()

        kappa_fn = None
        if self.diseq and self.ck.per_gas is not None:
            mixes = np.stack([np.asarray(
                0.5 * (profile_df[m].values[1:]
                       + profile_df[m].values[:-1]))
                for m in self.ck.per_gas_molecules])

            def kappa_fn(atm):
                return rr.resortrebin_kappa(
                    self.ck.per_gas, self.ck.arrays.t_inv_grid,
                    self.ck.arrays.p_log_grid, self.ck.arrays.nc_p,
                    jnp.asarray(self.ck.gauss_pts),
                    jnp.asarray(self.ck.gauss_wts), jnp.asarray(mixes),
                    jnp.asarray(atm.t_layer),
                    jnp.asarray(atm.p_layer / PCONV))

        common = self.bundle.inputs['approx']['rt_params']['common']
        return ck_rtprops(profile_df, self.ck, self.gravity,
                          p_reference=self.bundle.inputs['approx']
                          ['p_reference'],
                          delta_eddington=common['delta_eddington'],
                          stream=common['stream'], cld=cld,
                          molecular_kappa_fn=kappa_fn)


@functools.lru_cache(maxsize=8)
def _reconstruct_jitted(condensables):
    """Jitted reconstruct_profile (keyed by the static condensable-name
    tuple): un-jitted, the eager lax.scan pays one device dispatch per
    primitive instead of one for the whole program.

    Shape-stable across find_strat's zone search: core.zone_maps pads
    every ZoneMaps array to nlevel, so changing nstr/nofczns does NOT
    retrace (verified: one cache entry across three zone layouts)."""
    if condensables is None:
        return jax.jit(lambda beta, zones, plevel, adiabat:
                       core.reconstruct_profile(beta, zones, plevel,
                                                adiabat))
    return jax.jit(
        lambda beta, zones, plevel, adiabat, cond_abunds, weights:
        core.reconstruct_profile(
            beta, zones, plevel, adiabat,
            moist_args=(cond_abunds, condensables, weights)))


def _reconstruct_host(state, temp, pressure_bar, nstr, nofczns):
    """Adiabatic re-stitch of convective zones (climate.py:3037-3067);
    with moist set, the stitch follows the moist adiabat at the current
    chemistry (climate.py:3053)."""
    zones = core.zone_maps(nstr, nofczns, len(temp))
    if state.moist and state.condensables:
        fn = _reconstruct_jitted(tuple(state.condensables))
        t = fn(jnp.asarray(temp), zones,
               jnp.asarray(pressure_bar * PCONV), state.adiabat,
               state.data.cond_abunds,
               jnp.asarray(state._config_base['cond_weights']))
    else:
        t = _reconstruct_jitted(None)(
            jnp.asarray(temp), zones, jnp.asarray(pressure_bar * PCONV),
            state.adiabat)
    return np.asarray(t)


def _update_cond_abunds(state, df):
    """Refresh the condensable layer abundances the moist adiabat reads
    (fused.ClimateData.cond_abunds) from a host-side chemistry profile."""
    if not (state.moist and state.condensables):
        return
    lvl = np.stack([np.asarray(df[c], float)
                    for c in state.condensables], axis=1)
    lay = 0.5 * (lvl[1:] + lvl[:-1])
    state.data = state.data._replace(cond_abunds=jnp.asarray(lay))


def profile(state: _ClimateState, nofczns, nstr, temp, pressure_bar,
            it_max, itmx, conv, convt, x_max_mult, final,
            save_profile=False):
    """One opacity-refresh loop around the fused Newton solve
    (climate.py:2926-3249).  Each itmx iteration is ONE device dispatch of
    climate.fused.profile_step."""
    from . import fused

    temp = np.asarray(temp, float).copy()
    egp_stepmax = bool(temp.min() <= 250)
    zones = core.zone_maps(nstr, nofczns, len(temp))
    config = state.fused_config(it_max=it_max, egp_stepmax=egp_stepmax)

    temp_old = temp.copy()
    conv_flag = 0
    result = None
    # cloud-stability gate (climate.py:2913-2915/3227): taudif/taudif_tol
    # come from update_clouds' 4-step OPD-history averages
    taudif, taudif_tol = 0.0, 1.0
    host_path = state.diseq or state.cloudy
    state.last_nstr = list(nstr)
    temp_dev = jnp.asarray(temp)
    for iii in range(itmx):
        if host_path:
            # diseq/cloudy: chemistry+kzz+quench+virga on host, opacities
            # rebuilt (resort-rebin or premixed+clouds), Newton in one
            # jitted dispatch (climate.py:3083-3151 order of operations)
            # `temp` already mirrors temp_dev on host (single device_get
            # below) — no extra readback at the loop top
            temp = _reconstruct_host(state, temp, pressure_bar, nstr,
                                     nofczns)
            if state.diseq:
                df = state.update_diseq_chem(temp, pressure_bar)
            else:
                df = state.premix(temp, pressure_bar)
            _update_cond_abunds(state, df)
            cld_df = None
            if state.cloudy:
                if state.last_fluxes is None and not state.diseq:
                    state.bundle.inputs['atmosphere'].setdefault(
                        'kzz', {})['sc_kzz'] = np.zeros(len(temp)) + 1e9
                cld_df, _ = state.update_clouds(temp, pressure_bar)
                taudif = state.last_taudif
                taudif_tol = state.last_taudif_tol
            props, atm = state.build_props_host(df, cld_df=cld_df)
            temp_dev, converged, fnil, fnvl, fpit = fused.newton_solve(
                jnp.asarray(temp), props, zones, state.data, state.geom,
                state.ck.arrays, state.adiabat, config)
            dtdp = (jnp.diff(jnp.log(temp_dev))
                    / jnp.diff(jnp.log(state.data.plevel)))
        else:
            temp_dev, converged, dtdp, fnil, fnvl, fpit = \
                fused.profile_step(
                    temp_dev, zones, state.data, state.chem_grid,
                    state.ck.arrays, state.geom, state.adiabat, config)
        # ONE device->host fetch per iteration: every blocking
        # np.asarray waits for the device, so the per-array pulls (temp,
        # fluxes, dtdp, converged) are batched into one transfer
        temp, converged, dtdp, fnil, fnvl, fpit = jax.device_get(
            (temp_dev, converged, dtdp, fnil, fnvl, fpit))
        state.last_fluxes = (fnil, fpit)
        if save_profile:
            state.all_profiles.append(temp.copy())

        ert = float(np.abs(temp - temp_old).sum()) / (len(temp) * 1.5)
        temp_old = temp.copy()
        if state.verbose:
            print(f' profile it {iii}: mean|dT| {ert:.3f} K (conv {convt})')
        if state.runlog is not None:
            state.runlog.log('climate_iteration', it=iii, mean_dT=ert,
                             convt=convt, nstr=list(map(int, nstr)),
                             newton_converged=int(converged),
                             temperature=temp)
        result = (np.asarray(dtdp), np.asarray(fnil), np.asarray(fnvl),
                  np.asarray(fpit))
        # the reference's strict `taudif < taudif_tol` (climate.py:3228)
        # can never pass when the cloud OPD is identically zero (0 < 0):
        # a cloud-free cloudy=True run hangs the flag forever upstream.
        # The bypass is exactly that failure mode and no wider: when a
        # cloud exists (any nonzero averaged OPD) taudif_tol > 0, so an
        # unchanged cloud history already passes the strict gate first —
        # `taudif == 0.0` only decides when taudif_tol == 0 too, i.e.
        # both the current and previous 4-step OPD averages are all-zero
        if iii > 0 and ert < convt and (taudif < taudif_tol
                                        or taudif == 0.0):
            conv_flag = 1
            break

    # refresh the bundle chemistry at the converged structure — through
    # the SAME pathway the loop used: a plain equilibrium premix here
    # would erase the quench/kinetics abundances from the returned
    # profile (climate.py:3153-3209 re-runs the full chem update)
    if state.diseq:
        state.update_diseq_chem(temp, pressure_bar)
    else:
        state.premix(temp, pressure_bar)
    dtdp, fnil, fnvl, fpit = result
    return (conv_flag, temp, dtdp, fnil, fnvl, fpit)


def find_strat(state: _ClimateState, nofczns, nstr, temp, pressure_bar,
               dtdp, save_profile=False):
    """Convective-zone growth/merge search (climate.py:2542-2839)."""
    subad = 0.98
    ifirst = 10 - 1
    nstr = list(nstr)

    def conv_grad(temp):
        """convec (climate.py:570-608): dry or moist adiabatic gradient
        per layer at the CURRENT chemistry."""
        tbar = 0.5 * (temp[1:] + temp[:-1])
        pbar = np.sqrt(pressure_bar[1:] * pressure_bar[:-1])
        if state.moist and state.condensables:
            from .. import chemistry as chem_mod
            from .moist import moist_grad
            mix = chem_mod.chem_interp(state.chem_grid,
                                       jnp.asarray(tbar),
                                       jnp.asarray(pbar))
            cols = [state.chem_grid.species.index(c)
                    for c in state.condensables]
            cond = jnp.asarray(mix)[:, jnp.asarray(cols)].T
            weights = jnp.asarray(
                state._config_base['cond_weights'])
            grad_x, _ = moist_grad(jnp.asarray(tbar), jnp.asarray(pbar),
                                   state.adiabat, cond,
                                   state.condensables, weights)
        else:
            grad_x, _ = core.did_grad_cp(jnp.asarray(tbar),
                                         jnp.asarray(pbar),
                                         state.adiabat)
        return np.asarray(grad_x)

    args = dict(it_max=8, itmx=5, conv=5.0, convt=3.0, x_max_mult=7.0,
                final=False, save_profile=save_profile)

    # grad_x is computed ONCE at entry (reference climate.py:2647 never
    # refreshes it through the growth loops — only dtdp updates); kept
    # for zone-boundary trace parity with the reference
    grad_x = conv_grad(temp)
    while dtdp[nstr[1] - 1] >= subad * grad_x[nstr[1] - 1]:
        ratio = dtdp[nstr[1] - 1] / grad_x[nstr[1] - 1]
        nstr[1] -= 2 if ratio > 1.8 else 1
        if nstr[1] < 5:
            raise ValueError('Convection zone grew to the top of the '
                             'atmosphere; stopping')
        if state.verbose:
            print('find_strat: grow upper zone ->', nstr)
        (flag, temp, dtdp, fni, fnv, fpit) = profile(
            state, nofczns, nstr, temp, pressure_bar, **args)

    # detect a detached second zone by superadiabaticity (climate.py:2679)
    dt_max, i_max = 0.0, 0
    for i in range(nstr[1] - 1, ifirst - 1, -1):
        add = dtdp[i] - grad_x[i]
        if add > dt_max and add / grad_x[i] >= 0.02:
            dt_max, i_max = add, i
            break

    if not (i_max == 0 or dt_max / grad_x[i_max] < 0.02):
        if state.verbose:
            print('find_strat: detached zone at', i_max)
        nofczns = 2
        nstr[4], nstr[5] = nstr[1], nstr[2]
        nstr[1] = nstr[2] = nstr[3] = i_max
        if nstr[3] >= nstr[4]:
            raise ValueError('Convective-zone overlap')
        (flag, temp, dtdp, fni, fnv, fpit) = profile(
            state, nofczns, nstr, temp, pressure_bar, **args)

        i_change = 1
        while i_change == 1:
            i_change = 0
            d1, d2 = dtdp[nstr[1] - 1], dtdp[nstr[3]]
            c1, c2 = grad_x[nstr[1] - 1], grad_x[nstr[3]]
            while (d1 > subad * c1) or (d2 > subad * c2):
                if ((d1 - c1) >= (d2 - c2)) or (nofczns == 1):
                    nstr[1] -= 1
                    if nstr[1] < 3:
                        raise ValueError('Convection zone grew to the top')
                else:
                    nstr[2] += 1
                    nstr[3] += 1
                    if nstr[2] == nstr[4]:
                        nofczns = 1
                        nstr[2] = nstr[5]
                        nstr[3] = 0
                        i_change = 1
                if state.verbose:
                    print('find_strat: adjust ->', nstr)
                (flag, temp, dtdp, fni, fnv, fpit) = profile(
                    state, nofczns, nstr, temp, pressure_bar, **args)
                d1, d2 = dtdp[nstr[1] - 1], dtdp[nstr[3]]
                c1, c2 = grad_x[nstr[1] - 1], grad_x[nstr[3]]
            while (nofczns > 1
                   and dtdp[nstr[4] - 1] >= subad * grad_x[nstr[4] - 1]):
                nstr[4] -= 1
                if nstr[2] == nstr[4]:
                    nofczns = 1
                    nstr[2] = nstr[5]
                    nstr[3] = 0
                    i_change = 1
                if state.verbose:
                    print('find_strat: grow lower zone ->', nstr)
                (flag, temp, dtdp, fni, fnv, fpit) = profile(
                    state, nofczns, nstr, temp, pressure_bar, **args)

    # final strict-tolerance pass (climate.py:2798-2819)
    final_args = dict(it_max=10, itmx=6, conv=2.0, convt=2.0,
                      x_max_mult=3.5, final=True, save_profile=save_profile)
    if state.verbose:
        print('find_strat: final pass', nstr)
    (flag, temp, dtdp, fni, fnv, fpit) = profile(
        state, nofczns, nstr, temp, pressure_bar, **final_args)
    chem_df = state.bundle.inputs['atmosphere']['profile']
    return flag, temp, dtdp, nstr, fni, fnv, fpit, chem_df


def inputs_climate(case, temp_guess=None, pressure=None, rfaci=1,
                   rcb_guess=None, rfacv=None, moistgrad=False):
    """Port of justdoit.inputs_climate (justdoit.py:4883-4931)."""
    if case.inputs['planet'].get('T_eff', 0) in (0, None):
        raise ValueError('set T_eff via case.effective_temp() first')
    if not case.inputs['planet'].get('gravity'):
        raise ValueError('set gravity first')
    case.inputs['climate']['guess_temp'] = np.asarray(temp_guess, float)
    case.inputs['climate']['pressure'] = np.asarray(pressure, float)
    case.inputs['climate']['nstr'] = [0, int(rcb_guess),
                                      len(pressure) - 2, 0, 0, 0]
    case.inputs['climate']['nofczns'] = 1
    case.inputs['climate']['rfacv'] = rfacv
    case.inputs['climate']['rfaci'] = rfaci
    case.inputs['climate']['moistgrad'] = moistgrad
    case.add_pt(case.inputs['climate']['guess_temp'],
                case.inputs['climate']['pressure'])


def run_climate(case, opacityclass, save_all_profiles=False,
                with_spec=False, diseq_chem=False, verbose=True,
                runlog=None, mesh=None, **kwargs):
    """Top-level climate solve (port of justdoit.climate, :4982-5281).

    Workflows: chemical equilibrium (fully fused, one dispatch per profile
    iteration), disequilibrium (``diseq_chem=True``: self-consistent MLT
    kzz + Zahnle-Marley quenching, resort-rebin CK mixing when the
    connection carries per-gas tables), and cloudy (virga microphysics in
    the loop when ``case.inputs['climate']['cloudy']`` / virga kwargs are
    set).  Full photochemical kinetics requires the external photochem
    package (gated in :mod:`picaso_tpu.photochem`).

    ``mesh``: a ('batch', 'wave') :class:`jax.sharding.Mesh` — the CK
    and optics arrays are wave-sharded so every fused Newton dispatch of
    the WHOLE solve (all profile passes + find_strat) runs SPMD across
    the mesh (:func:`picaso_tpu.parallel.shard_climate_state`).
    """
    ck: CKTable = opacityclass.ck
    teff = case.inputs['planet']['T_eff']
    min_temp, max_temp = float(ck.temps.min()), float(ck.temps.max())
    tmin = min_temp * 0.7 if teff > 300 else 10.0
    tmax = 10000.0 if teff > 1600 else max_temp * 1.3

    pressure = case.inputs['climate']['pressure']
    temp = np.asarray(case.inputs['climate']['guess_temp'], float).copy()
    nstr = list(case.inputs['climate']['nstr'])
    nofczns = case.inputs['climate']['nofczns']
    rfaci = case.inputs['climate']['rfaci']

    if 'nostar' in str(case.inputs['star'].get('database')):
        rfacv = 0.0
        opacityclass.relative_flux = np.zeros(len(ck.wno)) + 1.0
    else:
        rfacv = case.inputs['climate']['rfacv']

    nlevel = len(pressure)
    if case.inputs['climate'].get('inject_energy'):
        # energy injection (justdoit.py:4953-4980 + fluxes.py:3671-3751)
        grav = case.inputs['planet']['gravity']  # cm/s^2
        pr = np.asarray(pressure, float)
        colden = np.diff(pr) * 1e6 / grav        # g/cm^2 per layer
        cl = case.inputs['climate']
        tidal = core.tidal_flux(
            teff, nlevel, pressure=pr, colden=colden,
            injection=dict(
                total_energy=cl.get('total_energy_injection', 0.0),
                press_max=cl.get('press_max_energy', 1.0),
                hratio=cl.get('injection_scaleheight', 1.0),
                inject_beam=cl.get('inject_beam', False),
                beam_profile=cl.get('beam_profile', 0.0)))
    else:
        tidal = core.tidal_flux(teff, nlevel)

    state = _ClimateState(case, opacityclass, tidal, rfaci, rfacv, tmin,
                          tmax, moist=case.inputs['climate'].get(
                              'moistgrad', False), verbose=verbose)
    state.diseq = bool(diseq_chem)
    state.runlog = runlog
    if mesh is not None:
        from ..parallel import shard_climate_state
        shard_climate_state(state, mesh)
    state.self_consistent_kzz = kwargs.get('self_consistent_kzz', True)
    virga_kwargs = case.inputs['climate'].get('virga_kwargs', {})
    state.cloudy = bool(case.inputs['climate'].get('cloudy', False)
                        or virga_kwargs)
    state.virga_kwargs = dict(virga_kwargs)
    if diseq_chem and ck.per_gas is None and verbose:
        print('diseq_chem=True with a premixed-only CK connection: quench '
              'adjustments affect continuum/mmw but molecular k stays '
              'premixed; supply per-gas tables for full resort-rebin '
              'mixing.')

    if diseq_chem:
        # climate.py:126-218 diseq workflow: one loose profile + find_strat
        flag, temp, dtdp, fni, fnv, fpit = profile(
            state, nofczns, nstr, temp, pressure, it_max=10, itmx=7,
            conv=5.0, convt=4.0, x_max_mult=7.0, final=False,
            save_profile=save_all_profiles)
        flag, temp, dtdp, nstr, fni, fnv, fpit, chem_df = find_strat(
            state, nofczns, nstr, temp, pressure, dtdp,
            save_profile=save_all_profiles)
        return _assemble_climate_output(
            case, state, opacityclass, pressure, temp, dtdp, nstr, fni,
            fnv, fpit, chem_df, tidal, rfaci, rfacv, save_all_profiles,
            with_spec, nlevel, flag=flag)

    # STEP 1: loose-tolerance profile (climate.py:270-290)
    flag, temp, dtdp, fni, fnv, fpit = profile(
        state, nofczns, nstr, temp, pressure, it_max=10, itmx=7, conv=10.0,
        convt=5.0, x_max_mult=7.0, final=False,
        save_profile=save_all_profiles)
    # STEP 2: stricter profile
    flag, temp, dtdp, fni, fnv, fpit = profile(
        state, nofczns, nstr, temp, pressure, it_max=7, itmx=5, conv=5.0,
        convt=4.0, x_max_mult=7.0, final=False,
        save_profile=save_all_profiles)
    # STEP 3: convective-zone search + final pass
    flag, temp, dtdp, nstr, fni, fnv, fpit, chem_df = find_strat(
        state, nofczns, nstr, temp, pressure, dtdp,
        save_profile=save_all_profiles)
    out = _assemble_climate_output(
        case, state, opacityclass, pressure, temp, dtdp, nstr, fni, fnv,
        fpit, chem_df, tidal, rfaci, rfacv, save_all_profiles, with_spec,
        nlevel)
    out['converged'] = flag
    return out


def _assemble_climate_output(case, state, opacityclass, pressure, temp,
                             dtdp, nstr, fni, fnv, fpit, chem_df, tidal,
                             rfaci, rfacv, save_all_profiles, with_spec,
                             nlevel, flag=1):
    flux_net = rfacv * fnv + rfaci * fni + tidal
    out = {
        'pressure': pressure, 'temperature': temp, 'ptchem_df': chem_df,
        'dtdp': dtdp, 'cvz_locs': nstr, 'flux_ir_attop': fpit,
        'converged': flag,
        'fnet/fnetir': flux_net / np.where(fni != 0, fni, np.nan),
        'flux_balance': dict(flux_net_ir=fni, flux_net_v=fnv, tidal=tidal,
                             rfacv=rfacv, rfaci=rfaci, flux_net=flux_net),
    }
    kz = case.inputs['atmosphere'].get('kzz', {})
    if isinstance(kz, dict) and kz.get('sc_kzz') is not None and \
            not isinstance(kz.get('sc_kzz'), int):
        out['kzz'] = np.asarray(kz['sc_kzz'])
    if state.cloudy:
        cld_df, cld_out = state.update_clouds(temp, pressure)
        out['cld_df'] = cld_df
        out['virga_output'] = cld_out
    if save_all_profiles:
        out['all_profiles'] = np.concatenate(
            [p[None] for p in state.all_profiles]) \
            if state.all_profiles else np.zeros((0, nlevel))
    if with_spec:
        case.atmosphere(df=chem_df)
        if state.cloudy:
            case.clouds(df=out['cld_df'])
        out['spectrum_output'] = case.spectrum(opacityclass,
                                               calculation='thermal',
                                               full_output=True)
    return out
