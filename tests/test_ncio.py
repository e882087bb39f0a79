"""NetCDF artifact interop: read reference-written files, write
xarray-convention files, round-trip models, GridFitter over .nc grids."""

import json
import os

import numpy as np
import pandas as pd
import pytest

from picaso_tpu import justdoit as jdi
from picaso_tpu import ncio
from picaso_tpu.io_utils import load_model, save_model
from picaso_tpu.opacities import factory

REF_NC = ('/root/reference/reference/base_cases/testing/'
          'model_storage_basecase.nc')

requires_ref = pytest.mark.skipif(not os.path.exists(REF_NC),
                                  reason='reference artifact unavailable')


@requires_ref
def test_read_reference_model_storage():
    """The reference's own test artifact decodes with correct structure
    (mirrors reference tests/test_notebooks.py:146-195 expectations)."""
    ds = ncio.read_netcdf(REF_NC)
    assert ds.dims['pressure'] == 61
    assert ds.dims['wavelength'] == 12040
    assert ds['albedo'].dims == ('wavelength',)
    assert ds['opd'].dims == ('pressure_layer', 'wavenumber_layer')
    assert ds['opd'].values.shape == (60, 196)
    alb = ds['albedo'].values
    assert np.isfinite(alb).any() and np.nanmax(alb) < 1.5
    pp = json.loads(ds.attrs['planet_params'])
    assert pp['rp']['unit'] == 'cm'
    assert ds.attrs['code'] == 'picaso'


@requires_ref
def test_reconstitute_case_from_reference_nc():
    """input_xarray-equivalent: a reference-written model file rebuilds a
    runnable inputs bundle (profile + clouds + gravity)."""
    case, spectra, attrs = load_model(REF_NC)
    prof = case.inputs['atmosphere']['profile']
    assert len(prof['pressure']) == 61
    assert 'H2O' in prof.keys() and 'temperature' in prof.keys()
    assert np.isclose(case.inputs['planet']['radius'], 7.1492e9)
    cld = case.inputs['clouds']['profile']
    assert cld is not None
    assert len(spectra['albedo']) == 12040
    # and the bundle actually runs a spectrum on a synthetic DB
    wno = np.linspace(9000.0, 20000.0, 200)
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        db = os.path.join(d, 's.db')
        factory.build_synthetic_db(db, wno, ntemp=6, npress=5)
        opa = jdi.opannection(filename_db=db)
        case.star(opa, 5000, 0, 4.0)
        df = case.spectrum(opa, calculation='reflected')
    assert np.isfinite(np.asarray(df['albedo'])).all()


def _run_case(tmp_path, teff=5700.0):
    wno = np.linspace(4000.0, 18000.0, 300)
    db = str(tmp_path / 'syn.db')
    factory.build_synthetic_db(db, wno, ntemp=6, npress=5)
    opa = jdi.opannection(filename_db=db)
    case = jdi.inputs()
    case.phase_angle(0)
    case.gravity(mass=1.0, mass_unit=jdi.u.Unit('M_jup'),
                 radius=1.1, radius_unit=jdi.u.Unit('R_jup'))
    case.star(opa, teff, 0.0, 4.4, radius=1.0,
              radius_unit=jdi.u.Unit('R_sun'), semi_major=0.1,
              semi_major_unit=jdi.u.Unit('au'))
    case.atmosphere(filename=jdi.jupiter_pt(), sep=r'\s+')
    case.clouds(filename=jdi.jupiter_cld(), sep=r'\s+')
    df = case.spectrum(opa, calculation='reflected+thermal')
    return case, df, opa


def test_nc_model_roundtrip(tmp_path):
    """output_xarray -> .nc -> input_xarray preserves values, attrs, and
    shapes (the reference's test_model_storage contract)."""
    case, df, opa = _run_case(tmp_path)
    path = str(tmp_path / 'model.nc')
    jdi.output_xarray(df, case, savefile=path,
                      add_output={'author': 'ncio tester'})

    ds = ncio.read_netcdf(path)
    assert ds['albedo'].dims == ('wavelength',)
    assert ds['flux_emission'].dims == ('wavelength',)
    assert ds['opd'].dims == ('pressure_layer', 'wavenumber_layer')
    assert ds.attrs['author'] == 'ncio tester'
    pp = json.loads(ds.attrs['planet_params'])
    assert np.isclose(pp['mp']['value'], 1.8981245973360505e30, rtol=1e-3)

    case2, spectra, attrs = load_model(path, opannection=opa)
    wave = 1e4 / np.asarray(df['wavenumber'])
    order = np.argsort(wave)
    np.testing.assert_allclose(spectra['albedo'],
                               np.asarray(df['albedo'])[order],
                               atol=1e-12)
    prof1 = case.inputs['atmosphere']['profile']
    prof2 = case2.inputs['atmosphere']['profile']
    for col in prof1.keys():
        np.testing.assert_allclose(np.asarray(prof2[col]),
                                   np.asarray(prof1[col]), rtol=1e-10)
    # reconstituted bundle reruns and reproduces the spectrum
    df2 = case2.spectrum(opa, calculation='reflected')
    np.testing.assert_allclose(np.asarray(df2['albedo']),
                               np.asarray(df['albedo']), rtol=2e-4)


def test_gcm_netcdf_input_3d(tmp_path):
    """A GCM NetCDF in the community convention (vars on (lon, lat,
    pressure)) feeds atmosphere_3d and runs a 3D thermal spectrum."""
    nlon, nlat, nlev = 8, 4, 20
    lon = np.linspace(-180, 180 - 360 / nlon, nlon)
    lat = np.linspace(-60, 60, nlat)
    pressure = np.logspace(-4, 2, nlev)
    temp = (1000.0 + 200.0 * np.cos(np.radians(lon))[:, None, None]
            * np.cos(np.radians(lat))[None, :, None]
            + 300.0 * np.log10(pressure)[None, None, :] / 4.0)
    h2o = np.full((nlon, nlat, nlev), 5e-4)
    path = str(tmp_path / 'gcm.nc')
    ncio.write_netcdf(
        path,
        {'temperature': (('lon', 'lat', 'pressure'), temp,
                         {'units': 'K'}),
         'H2O': (('lon', 'lat', 'pressure'), h2o, {'units': 'v/v'}),
         'H2': (('lon', 'lat', 'pressure'),
                np.full((nlon, nlat, nlev), 0.85), {'units': 'v/v'}),
         'He': (('lon', 'lat', 'pressure'),
                np.full((nlon, nlat, nlev), 0.15), {'units': 'v/v'})},
        coords={'lon': (lon, {'units': 'deg'}),
                'lat': (lat, {'units': 'deg'}),
                'pressure': (pressure, {'units': 'bar'})})

    d = ncio.gcm_dict(path)
    assert d['temperature'].shape == (nlev, nlon, nlat)

    wno = np.linspace(2000.0, 8000.0, 120)
    db = str(tmp_path / 'gcm_syn.db')
    factory.build_synthetic_db(db, wno, ntemp=6, npress=5)
    opa = jdi.opannection(filename_db=db)
    case = jdi.inputs()
    case.phase_angle(0, num_gangle=4, num_tangle=4)
    case.gravity(gravity=20, gravity_unit=jdi.u.Unit('m/(s**2)'))
    case.setup_nostar()
    case.atmosphere_3d(path)
    df = case.spectrum(opa, calculation='thermal', dimension='3d')
    assert np.isfinite(np.asarray(df['thermal'])).all()


def test_gridfitter_reads_nc_grid(tmp_path):
    """GridFitter consumes a directory of NetCDF models (the community
    xarray grid format, analyze.py:184)."""
    from picaso_tpu.analyze import GridFitter

    case, df, opa = _run_case(tmp_path)
    gdir = tmp_path / 'grid'
    gdir.mkdir()
    for i, scale in enumerate((1.0, 1.2)):
        out = dict(df)
        out['fpfs_thermal'] = np.asarray(df['fpfs_thermal']) * scale
        jdi.output_xarray(out, case, savefile=str(gdir / f'm{i}.nc'),
                          add_output={'tint': 100.0 * (i + 1)})

    fitter = GridFitter('syngrid', str(gdir), verbose=False)
    assert fitter.spectra.shape[0] == 2
    assert 'tint' in fitter.grid_params.columns
    wl = 1e4 / np.asarray(df['wavenumber'])[::10]
    y = np.asarray(df['fpfs_thermal'])[::10]
    fitter.fit_grid('syngrid', 'data', wl, y, y * 0.05 + 1e-30)
    best = fitter.fit_results['syngrid']['data']['best_fit_index']
    assert best == 0  # the unscaled model wins
