"""I/O helpers: JSON/HDF readers, climate iterate dumps, and model
preservation round-trips.

Covers the reference ``io_utils.py`` plus the xarray preservation layer
(``justdoit.py:630-1089`` output_xarray/input_xarray).  xarray is not part
of this environment, so models are stored as self-describing HDF5 (datasets
+ attrs) with the same information content; ``load_model`` reconstitutes a
runnable ``inputs`` bundle exactly like ``input_xarray``.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pandas as pd

__all__ = ['read_json', 'read_hdf', 'write_all_profiles', 'read_visscher',
           'merge_models', 'save_model', 'load_model', 'save_model_nc',
           'load_model_nc', 'standard_metadata']


def read_json(filename, **kwargs):
    with open(filename) as f:
        return json.load(f, **kwargs)


def read_hdf(filename, key=None):
    import h5py
    out = {}
    with h5py.File(filename, 'r') as f:
        src = f[key] if key else f
        for k in src:
            out[k] = np.asarray(src[k])
    return out


def write_all_profiles(filename, all_profiles, nlevel, all_opd=None,
                       all_kzz=None):
    """Dump climate iteration history (io_utils.py:82 semantics)."""
    import h5py
    arr = np.asarray(all_profiles).reshape(-1, nlevel)
    with h5py.File(filename, 'w') as f:
        f.create_dataset('all_profiles', data=arr)
        if all_opd is not None and len(np.atleast_1d(all_opd)):
            f.create_dataset('all_opd',
                             data=np.asarray(all_opd).reshape(
                                 -1, nlevel - 1))
        if all_kzz is not None and len(np.atleast_1d(all_kzz)):
            f.create_dataset('all_kzz', data=np.asarray(all_kzz))
    return filename


def read_visscher(filename):
    """Read a visscher chemistry grid table (io_utils.py:7 semantics)."""
    return pd.read_csv(filename)


def read_visscher_2121(filename):
    """Parse a raw 1060/2121-point Visscher grid text file into a tidy
    (pressure, temperature, abundances) DataFrame (io_utils.py:7-80)."""
    from .justdoit import _parse_visscher_grid
    return _parse_visscher_grid(filename)


def standard_metadata():
    """Template metadata tree for stored models (justdoit.py:630-663)."""
    return {
        'author': '', 'contact': '', 'code': 'picaso_tpu',
        'doi': '', 'planet_params': {}, 'stellar_params': {},
        'orbit_params': {},
    }


_SPEC_VARS = {
    # stored-name: (output-dict key, units) — reference output_xarray
    # naming (justdoit.py:798-818)
    'albedo': ('albedo', 'none'),
    'fpfs_reflected': ('fpfs_reflected',
                       'erg/cm**2/s/cm/(erg/cm**2/s/cm)'),
    'flux_emission': ('thermal', 'erg/cm**2/s/cm'),
    'fpfs_emission': ('fpfs_thermal',
                      'erg/cm**2/s/cm/(erg/cm**2/s/cm)'),
    'transit_depth': ('transit_depth', 'R_jup**2/R_jup**2'),
    'temp_brightness': ('temp_brightness', 'Kelvin'),
}


def _qty(value, unit):
    return {'value': float(value), 'unit': unit}


def save_model_nc(filename, case, out, meta=None):
    """Persist a computed model as reference-layout NetCDF
    (output_xarray, justdoit.py:705-980): spectra on a micron
    'wavelength' coord, profile columns on 'pressure', clouds as
    opd/ssa/asy on (pressure_layer, wavenumber_layer), and
    planet/stellar/orbit params as json attrs.  Readable by
    xarray/netcdf4 and by the reference's input_xarray."""
    from .ncio import write_netcdf

    meta = meta or {}
    prof = case.inputs['atmosphere']['profile']
    pressure = np.asarray(prof['pressure'], np.float64)
    data_vars = {}
    coords = {'pressure': (pressure, {'units': 'bar'})}
    for col in prof.keys():
        if col == 'pressure':
            continue
        units = 'Kelvin' if col == 'temperature' else 'v/v'
        data_vars[str(col)] = (('pressure',),
                               np.asarray(prof[col], np.float64),
                               {'units': units})
    if isinstance(out, dict) and 'wavenumber' in out:
        wave = 1e4 / np.asarray(out['wavenumber'], np.float64)
        order = np.argsort(wave)
        coords['wavelength'] = (wave[order], {'units': 'micron'})
        for name, (key, units) in _SPEC_VARS.items():
            v = out.get(key)
            if isinstance(v, np.ndarray) and v.shape == wave.shape:
                data_vars[name] = (('wavelength',), v[order],
                                   {'units': units})
    cld = case.inputs['clouds'].get('profile')
    if cld is not None and not isinstance(cld, dict):
        cld_wno = np.asarray(case.inputs['clouds']['wavenumber'],
                             np.float64)
        nlayer = len(pressure) - 1
        for store, col in (('opd', 'opd'), ('ssa', 'w0'), ('asy', 'g0')):
            arr = np.reshape(np.asarray(cld[col], np.float64),
                             (nlayer, len(cld_wno)))
            data_vars[store] = (('pressure_layer', 'wavenumber_layer'),
                                arr, {'units': 'unitless'})
        coords['pressure_layer'] = (
            np.sqrt(pressure[1:] * pressure[:-1]), {'units': 'bar'})
        coords['wavenumber_layer'] = (cld_wno, {'units': 'cm**(-1)'})

    planet = case.inputs['planet']
    pp = {}
    if planet.get('mass') and np.isfinite(planet['mass']):
        pp['mp'] = _qty(planet['mass'], 'g')
        pp['rp'] = _qty(planet['radius'], 'cm')
    elif planet.get('gravity'):
        pp['gravity'] = _qty(planet['gravity'], 'cm/s**2')
    pref = case.inputs['approx'].get('p_reference')
    if pref is not None:
        pp['p_reference'] = _qty(pref, 'bar')
    star = case.inputs['star']
    sp = {}
    for k_store, k_in in (('database', 'database'), ('steff', 'temp'),
                          ('feh', 'metal'), ('logg', 'logg')):
        if star.get(k_in) is not None:
            sp[k_store] = star[k_in]
    if isinstance(star.get('radius'), (int, float)) and \
            np.isfinite(star['radius']):
        sp['rs'] = _qty(star['radius'], 'cm')
    op = {}
    if isinstance(star.get('semi_major'), (int, float)) and \
            np.isfinite(star['semi_major']):
        op['sma'] = _qty(star['semi_major'], 'cm')

    attrs = {'code': 'picaso_tpu', 'planet_params': pp}
    if sp:
        attrs['stellar_params'] = sp
    if op:
        attrs['orbit_params'] = op
    attrs.update(meta)
    return write_netcdf(filename, data_vars, coords=coords, attrs=attrs)


def load_model_nc(filename, opannection=None):
    """Reconstitute an inputs bundle from a NetCDF model — reference- or
    picaso_tpu-written (input_xarray, justdoit.py:979-1089)."""
    from .ncio import read_netcdf
    from .justdoit import inputs as _inputs
    from . import units as u

    ds = read_netcdf(filename)

    def parse(v):
        # attrs are json-encoded dicts, but some reference files carry
        # python-repr dicts (e.g. cloud_params "{'fsed': 3}")
        if isinstance(v, str) and v.lstrip().startswith('{'):
            try:
                return json.loads(v)
            except ValueError:
                import ast
                try:
                    return ast.literal_eval(v)
                except (ValueError, SyntaxError):
                    return v
        return v

    attrs = {k: parse(v) for k, v in ds.attrs.items()}

    pressure = ds.coords['pressure'].values
    prof = {'pressure': pressure}
    spectra = {}
    for name, var in ds.data_vars.items():
        if var.dims == ('pressure',):
            prof[name] = var.values
        elif var.dims == ('wavelength',):
            inv = {store: out_key for store, (out_key, _) in
                   _SPEC_VARS.items()}
            spectra[inv.get(name, name)] = var.values
    if 'wavelength' in ds.coords:
        spectra['wavenumber'] = 1e4 / ds.coords['wavelength'].values

    case = _inputs()
    case.phase_angle(0)
    pp = attrs.get('planet_params', {})
    if 'mp' in pp and 'rp' in pp:
        case.gravity(mass=pp['mp']['value'],
                     mass_unit=u.Unit(pp['mp']['unit']),
                     radius=pp['rp']['value'],
                     radius_unit=u.Unit(pp['rp']['unit']))
    elif 'gravity' in pp:
        case.gravity(gravity=pp['gravity']['value'],
                     gravity_unit=u.Unit(pp['gravity']['unit']))
    if 'p_reference' in pp:
        case.approx(p_reference=u.Unit(pp['p_reference']['unit']).to(
            u.Unit('bar')) * pp['p_reference']['value'])
    case.atmosphere(df=pd.DataFrame(prof))

    if 'opd' in ds.data_vars:
        wno_l = (ds.coords['wavenumber_layer'].values
                 if 'wavenumber_layer' in ds.coords
                 else None)
        nlayer, nw = ds['opd'].values.shape
        if wno_l is None:
            from .wavelength import get_cld_input_grid
            wno_l = get_cld_input_grid() if nw == 196 else np.arange(nw)
        cld_df = pd.DataFrame({
            'opd': ds['opd'].values.ravel(),
            'w0': ds['ssa'].values.ravel(),
            'g0': ds['asy'].values.ravel(),
            'wavenumber': np.tile(wno_l, nlayer),
            'pressure': np.repeat(np.sqrt(pressure[1:] * pressure[:-1]),
                                  nw)})
        case.clouds(df=cld_df)

    sp = attrs.get('stellar_params', {})
    if opannection is not None and sp.get('steff') is not None:
        kw = {}
        if isinstance(sp.get('rs'), dict):
            kw.update(radius=sp['rs']['value'],
                      radius_unit=u.Unit(sp['rs']['unit']))
        sma = attrs.get('orbit_params', {}).get('sma')
        if isinstance(sma, dict):
            kw.update(semi_major=sma['value'],
                      semi_major_unit=u.Unit(sma['unit']))
        case.star(opannection, sp['steff'], sp.get('feh', 0.0),
                  sp.get('logg', 4.5),
                  database=sp.get('database', 'ck04models'), **kw)
    return case, spectra, attrs


def _is_netcdf(filename):
    if str(filename).endswith('.nc'):
        return True
    import h5py
    try:
        with h5py.File(filename, 'r') as f:
            return '_NCProperties' in f.attrs or any(
                'DIMENSION_SCALE' == (v.attrs.get('CLASS', b'').decode()
                                      if isinstance(v.attrs.get('CLASS'),
                                                    bytes)
                                      else v.attrs.get('CLASS'))
                for v in f.values() if isinstance(v, h5py.Dataset))
    except OSError:
        return False


def save_model(filename, case, out, calculation='all', meta=None):
    """Persist a computed model: spectra + profile + inputs.

    ``.nc`` paths write the reference's NetCDF layout (save_model_nc);
    anything else writes the legacy self-describing HDF5 layout.  The JAX
    analog of output_xarray (justdoit.py:705): everything needed to
    re-plot or re-run lives in one self-describing file.
    """
    if str(filename).endswith('.nc'):
        return save_model_nc(filename, case, out, meta=meta)
    import h5py
    meta = meta or {}
    prof = case.inputs['atmosphere']['profile']
    with h5py.File(filename, 'w') as f:
        spec = f.create_group('spectra')
        for key in ('wavenumber', 'albedo', 'thermal', 'transit_depth',
                    'fpfs_thermal', 'fpfs_reflected', 'fpfs_total'):
            if key in out and isinstance(out[key], np.ndarray):
                spec.create_dataset(key, data=out[key])
        pg = f.create_group('profile')
        for col in prof.keys():
            pg.create_dataset(str(col), data=np.asarray(prof[col],
                                                        dtype=np.float64))
        cld = case.inputs['clouds'].get('profile')
        if cld is not None and not isinstance(cld, dict):
            cg = f.create_group('clouds')
            for col in ('opd', 'g0', 'w0'):
                cg.create_dataset(col, data=np.asarray(cld[col],
                                                       dtype=np.float64))
            cld_wno = case.inputs['clouds'].get('wavenumber')
            if cld_wno is not None:
                cg.create_dataset('wavenumber',
                                  data=np.asarray(cld_wno,
                                                  dtype=np.float64))
        attrs = {
            'planet_gravity': case.inputs['planet'].get('gravity'),
            'planet_radius': case.inputs['planet'].get('radius'),
            'planet_mass': case.inputs['planet'].get('mass'),
            'star_temp': case.inputs['star'].get('temp'),
            'star_radius': case.inputs['star'].get('radius'),
            'star_semi_major': case.inputs['star'].get('semi_major'),
            'phase_angle': case.inputs.get('phase_angle'),
            'p_reference': case.inputs['approx'].get('p_reference'),
        }
        for k, v in {**attrs, **meta}.items():
            if v is None:
                continue
            try:
                f.attrs[k] = v
            except TypeError:
                f.attrs[k] = json.dumps(v)
    return filename


def load_model(filename, opannection=None):
    """Reconstitute an ``inputs`` bundle + stored spectra (input_xarray).

    Auto-detects NetCDF (reference- or picaso_tpu-written) vs the legacy
    HDF5 layout."""
    if _is_netcdf(filename):
        return load_model_nc(filename, opannection=opannection)
    import h5py
    from .justdoit import inputs as _inputs

    with h5py.File(filename, 'r') as f:
        prof = {k: np.asarray(v) for k, v in f['profile'].items()}
        spectra = {k: np.asarray(v) for k, v in f['spectra'].items()}
        attrs = dict(f.attrs)
        clouds = ({k: np.asarray(v) for k, v in f['clouds'].items()}
                  if 'clouds' in f else None)

    case = _inputs()
    case.phase_angle(float(attrs.get('phase_angle', 0.0) or 0.0))
    grav = attrs.get('planet_gravity')
    radius = attrs.get('planet_radius')
    mass = attrs.get('planet_mass')
    from . import units as u
    if (radius is not None and mass is not None
            and np.isfinite(radius) and np.isfinite(mass)):
        case.gravity(radius=float(radius), radius_unit=u.Unit('cm'),
                     mass=float(mass), mass_unit=u.Unit('g'))
    elif grav is not None:
        case.gravity(gravity=float(grav), gravity_unit=u.Unit('cm/(s**2)'))
    case.atmosphere(df=pd.DataFrame(prof))
    if clouds is not None:
        cld_df = pd.DataFrame({k: clouds[k] for k in ('opd', 'g0', 'w0')})
        if 'wavenumber' in clouds:
            nlayer = len(prof['pressure']) - 1
            nw = len(clouds['wavenumber'])
            cld_df['wavenumber'] = np.tile(clouds['wavenumber'], nlayer)
            pressure = np.sqrt(np.asarray(prof['pressure'])[1:]
                               * np.asarray(prof['pressure'])[:-1])
            cld_df['pressure'] = np.repeat(pressure, nw)
        case.clouds(df=cld_df)
    star_temp = attrs.get('star_temp')
    if opannection is not None and star_temp is not None and \
            not isinstance(star_temp, str):
        kw = {}
        sr = attrs.get('star_radius')
        sa = attrs.get('star_semi_major')
        if sr is not None and np.isfinite(sr):
            kw.update(radius=float(sr), radius_unit=u.Unit('cm'))
        if sa is not None and np.isfinite(sa):
            kw.update(semi_major=float(sa), semi_major_unit=u.Unit('cm'))
        case.star(opannection, float(star_temp), 0.0, 4.5, **kw)
    return case, spectra, attrs


def merge_models(outputs, concat_dim='model'):
    """Merge several computed-model dicts into stacked arrays.

    Parity role of justdoit.merge_xarrays (justdoit.py:664): given an
    iterable of spectrum dicts (or .h5 paths written by save_model),
    returns one dict with each spectral key stacked along a leading
    model axis plus the shared wavenumber grid.
    """
    import h5py
    dicts = []
    for o in outputs:
        if isinstance(o, (str, bytes)):
            with h5py.File(o, 'r') as f:
                dicts.append({k: np.asarray(v)
                              for k, v in f['spectra'].items()})
        else:
            dicts.append(o)
    keys = set(dicts[0])
    for d in dicts[1:]:
        keys &= set(d)
    out = {}
    for k in sorted(keys):
        if k == 'wavenumber':
            out[k] = np.asarray(dicts[0][k])
        else:
            try:
                out[k] = np.stack([np.asarray(d[k]) for d in dicts])
            except ValueError:
                out[k] = [d[k] for d in dicts]
    out[f'n_{concat_dim}'] = len(dicts)
    return out
