"""Opacity factory: build opacity databases (offline tooling).

Analog of the reference ``opacity_factory.py``: writes sqlite databases
in the exact schema consumed by :mod:`picaso_tpu.opacities.db` (and by the
reference itself), and also builds *synthetic but physically-shaped*
opacity sets in memory for tests and benchmarks — deterministic pseudo-line
bands with temperature/pressure broadening, spanning the same ~1e-33..1e-18
cm^2/molecule dynamic range as real cross sections.

Schema (matches reference opacity_factory.py:622-740):
  header(id, pressure_unit, temperature_unit, wavenumber_grid array, ...)
  molecular(id, molecule TEXT, ptid INT, pressure FLOAT, temperature FLOAT,
            opacity array)
  continuum(id, molecule TEXT, temperature FLOAT, opacity array)
"""

from __future__ import annotations

import sqlite3
import zlib
from typing import Sequence

import jax
import numpy as np

from .db import PTGrid, OpacityGrid, _adapt_array

__all__ = ['synthetic_cross_sections', 'build_synthetic_db',
           'synthetic_opacity_grid', 'default_pt_grid',
           'production_pt_grid', 'synthetic_opacity_grid_ragged']


def default_pt_grid(ntemp=20, npress=15):
    """A regular (T, P) grid shaped like the 1060 grid (same per-T count)."""
    temps = np.linspace(75, 3400, ntemp)
    pressures = np.logspace(-6, 3, npress)   # bar
    return temps, pressures


def synthetic_cross_sections(molecule, wno, temps, pressures, seed=1234,
                             n_bands=12):
    """Deterministic band-structured cross sections sigma(T, P, wno).

    Lorentzian-envelope bands whose strength scales with T (Boltzmann-ish)
    and whose width scales with P (pressure broadening) — not real physics,
    but the right shape/dynamic range to exercise interpolation, resampling
    and RT end-to-end.  Returns [ntemp, npress, nwno] in cm^2/molecule.
    """
    rng = np.random.default_rng(zlib.crc32(molecule.encode()) + seed)
    wmin, wmax = wno.min(), wno.max()
    centers = rng.uniform(wmin, wmax, n_bands)
    widths = rng.uniform(0.01, 0.08, n_bands) * (wmax - wmin)
    strengths = 10 ** rng.uniform(-26, -21, n_bands)
    t_exp = rng.uniform(-1.0, 1.5, n_bands)

    sigma = np.zeros((len(temps), len(pressures), len(wno)))
    base = 1e-33  # floor continuum
    for it, T in enumerate(temps):
        for ip, P in enumerate(pressures):
            broad = 1.0 + 0.15 * np.log10(max(P, 1e-6) / 1e-6)
            s = np.zeros(len(wno)) + base * (T / 1000.0)
            for c, w, amp, te in zip(centers, widths, strengths, t_exp):
                s = s + (amp * (T / 1000.0) ** te
                         / (1.0 + ((wno - c) / (w * broad)) ** 2))
            sigma[it, ip] = s
    return sigma


def build_synthetic_db(filename, wno, molecules=('H2O', 'CH4', 'CO', 'NH3'),
                       continuum=('H2H2', 'H2He'), ntemp=8, npress=6,
                       cia_temps=None, seed=1234, pt_layout='regular'):
    """Write a reference-schema sqlite DB with synthetic opacities.

    ``pt_layout='1060'`` writes the production monochromatic-DB layout:
    the ragged 1060-point (T, P) grid (60 temperatures x 15-18 pressures
    each, :func:`production_pt_grid`) with one ``molecular`` row per
    flat grid point, exactly as the Zenodo R=15k databases are laid out
    (reference opacity_factory.py:622-740) — so loaders, the ragged
    ``nc_p`` index math, and golden-test plumbing can be exercised
    without the 7 GB download.
    """
    if pt_layout == '1060':
        temps_flat, press_flat, _ = production_pt_grid()
    else:
        temps, pressures = default_pt_grid(ntemp, npress)
    if cia_temps is None:
        cia_temps = np.linspace(100, 3000, 10)

    sqlite3.register_adapter(np.ndarray, _adapt_array)
    conn = sqlite3.connect(filename, detect_types=sqlite3.PARSE_DECLTYPES)
    cur = conn.cursor()
    cur.execute('CREATE TABLE header (id INTEGER PRIMARY KEY, '
                'pressure_unit VARCHAR, temperature_unit VARCHAR, '
                'wavenumber_grid array, continuum_unit VARCHAR, '
                'molecular_unit VARCHAR)')
    cur.execute('INSERT INTO header (pressure_unit, temperature_unit, '
                'wavenumber_grid, continuum_unit, molecular_unit) '
                'VALUES (?,?,?,?,?)',
                ('bar', 'kelvin', np.asarray(wno, np.float64),
                 'cm-1 amagat-2', 'cm2/molecule'))
    cur.execute('CREATE TABLE molecular (id INTEGER PRIMARY KEY, '
                'molecule VARCHAR, ptid INTEGER, pressure FLOAT, '
                'temperature FLOAT, opacity array)')
    cur.execute('CREATE TABLE continuum (id INTEGER PRIMARY KEY, '
                'molecule VARCHAR, temperature FLOAT, opacity array)')

    for mol in molecules:
        if pt_layout == '1060':
            log_sig = np.asarray(_band_sigma_flat(
                mol, np.asarray(wno), temps_flat, press_flat, seed=seed),
                np.float64)
            for ptid0, (T, P) in enumerate(zip(temps_flat, press_flat)):
                cur.execute('INSERT INTO molecular (molecule, ptid, '
                            'pressure, temperature, opacity) '
                            'VALUES (?,?,?,?,?)',
                            (mol, ptid0 + 1, float(P), float(T),
                             10.0 ** log_sig[ptid0]))
            continue
        sigma = synthetic_cross_sections(mol, np.asarray(wno), temps,
                                         pressures, seed=seed)
        ptid = 0
        for it, T in enumerate(temps):
            for ip, P in enumerate(pressures):
                ptid += 1
                cur.execute('INSERT INTO molecular (molecule, ptid, '
                            'pressure, temperature, opacity) '
                            'VALUES (?,?,?,?,?)',
                            (mol, ptid, float(P), float(T),
                             sigma[it, ip].astype(np.float64)))
    wno_arr = np.asarray(wno)
    for mol in continuum:
        rng = np.random.default_rng(zlib.crc32(mol.encode()))
        shape = 10 ** (-8 + 2 * np.sin(wno_arr / wno_arr.max() * 6
                                       + rng.uniform(0, 3)))
        for T in cia_temps:
            cur.execute('INSERT INTO continuum (molecule, temperature, '
                        'opacity) VALUES (?,?,?)',
                        (mol, float(T),
                         (shape * (T / 1000.0) ** 0.5).astype(np.float64)))
    conn.commit()
    conn.close()
    return filename


def synthetic_opacity_grid(wno, molecules=('H2O', 'CH4', 'CO', 'NH3'),
                           continuum=('H2H2', 'H2He'), ntemp=8, npress=6,
                           seed=1234, dtype=np.float32) -> OpacityGrid:
    """Build an in-memory OpacityGrid directly (no sqlite round trip).

    Used by bench.py for full-resolution (nwno~5e4) runs where writing a
    multi-GB sqlite file first would dominate setup time.
    """
    import jax.numpy as jnp

    wno = np.asarray(wno, np.float64)
    temps, pressures = default_pt_grid(ntemp, npress)
    npt = ntemp * npress
    log_kappa = np.zeros((len(molecules), npt, len(wno)), dtype)
    for im, mol in enumerate(molecules):
        sigma = synthetic_cross_sections(mol, wno, temps, pressures,
                                         seed=seed)
        log_kappa[im] = np.log10(
            np.where(sigma > 0, sigma, 1e-50)).reshape(npt, -1)

    cia_temps = np.linspace(100, 3000, 10)
    cont = np.zeros((len(continuum), len(cia_temps), len(wno)), dtype)
    for im, mol in enumerate(continuum):
        rng = np.random.default_rng(zlib.crc32(mol.encode()))
        shape = 10 ** (-8 + 2 * np.sin(wno / wno.max() * 6
                                       + rng.uniform(0, 3)))
        for it, T in enumerate(cia_temps):
            cont[im, it] = shape * (T / 1000.0) ** 0.5

    nc_p = np.full(ntemp, npress, np.int32)
    t_offset = np.concatenate([[0], np.cumsum(nc_p)[:-1]]).astype(np.int32)
    pt = PTGrid(t_inv_grid=jnp.asarray(1.0 / temps, dtype),
                p_log_grid=jnp.asarray(np.log10(pressures), dtype),
                nc_p=jnp.asarray(nc_p), t_offset=jnp.asarray(t_offset))
    return OpacityGrid(wno=jnp.asarray(wno), log_kappa=jnp.asarray(log_kappa),
                       pt=pt, cont_opa=jnp.asarray(cont),
                       cia_temps=jnp.asarray(cia_temps, dtype),
                       molecules=tuple(molecules),
                       continuum_molecules=tuple(continuum))


def production_pt_grid():
    """The ragged 1060-point (T, P) grid of the production monochromatic
    DBs (60 temperatures x 15-18 pressures each; layout read from the
    bundled Visscher chemistry table which is tabulated on that grid).

    Returns (temps_flat [1060], press_flat [1060], nc_p [60]).
    """
    from ..refdata import refdata_path
    import pandas as pd

    df = pd.read_csv(refdata_path('chemistry',
                                  '2015_06_1060grid_feh_00_co_10.txt'),
                     sep=r'\s+', skiprows=1, header=None,
                     usecols=[0, 1], names=['T', 'logP'])
    temps_flat = df['T'].values.astype(np.float64)
    press_flat = (10.0 ** df['logP'].values).astype(np.float64)
    _, idx, counts = np.unique(temps_flat, return_index=True,
                               return_counts=True)
    order = np.argsort(idx)
    nc_p = counts[order].astype(np.int32)
    return temps_flat, press_flat, nc_p


def _band_sigma_flat(molecule, wno, temps_flat, press_flat, seed=1234,
                     n_bands=12):
    """Vectorized band-model cross sections on a FLAT ragged PT list.

    Same band model as :func:`synthetic_cross_sections`, evaluated ON
    DEVICE with a single jitted program (one [npt, nwno] table per call)
    — building the 16 x 1060 x 50k production-shaped cube takes seconds
    instead of the minutes a host-numpy sweep costs, and the result never
    round-trips through host memory.  Returns log10 sigma [npt, nwno]
    (float32, device array).
    """
    import jax.numpy as jnp

    rng = np.random.default_rng(zlib.crc32(molecule.encode()) + seed)
    wmin, wmax = wno.min(), wno.max()
    centers = rng.uniform(wmin, wmax, n_bands)
    widths = rng.uniform(0.01, 0.08, n_bands) * (wmax - wmin)
    strengths = 10 ** rng.uniform(-26, -21, n_bands)
    t_exp = rng.uniform(-1.0, 1.5, n_bands)
    return _band_sigma_device(
        jnp.asarray(wno, jnp.float32),
        jnp.asarray(temps_flat, jnp.float32),
        jnp.asarray(press_flat, jnp.float32),
        jnp.asarray(centers, jnp.float32), jnp.asarray(widths, jnp.float32),
        jnp.asarray(strengths, jnp.float32),
        jnp.asarray(t_exp, jnp.float32))


@jax.jit
def _band_sigma_device(wno, temps_flat, press_flat, centers, widths,
                       strengths, t_exp):
    import jax.numpy as jnp

    broad = 1.0 + 0.15 * jnp.log10(jnp.maximum(press_flat, 1e-6) / 1e-6)
    tfac = temps_flat / 1000.0                              # [npt]
    # sigma can underflow f32 (1e-33 floor); compute log10 via a rescale:
    # s = 1e-33*tfac + sum_b amp_b * tfac^te_b / (1 + d^2), all amp ~1e-26
    # -> scale by 1e30 so intermediates sit in f32 range, subtract 30 after
    s = (1e-33 * 1e30) * tfac[:, None] * jnp.ones_like(wno)[None, :]

    def add_band(s, band):
        c, w, amp, te = band
        d = (wno[None, :] - c) / (w * broad[:, None])
        return s + (amp * 1e30) * tfac[:, None] ** te / (1.0 + d * d), None

    s, _ = jax.lax.scan(add_band, s,
                        (centers, widths, strengths, t_exp))
    return jnp.log10(s) - 30.0


def synthetic_opacity_grid_ragged(wno, molecules, seed=1234,
                                  dtype=np.float32) -> OpacityGrid:
    """Production-shaped OpacityGrid: the ragged 1060-point PT grid with
    synthetic band-model opacities for ``molecules`` (benchmarking the
    real workload shape — HBM footprint, ragged index math, molecule
    count — without the 7 GB download)."""
    import jax.numpy as jnp

    wno = np.asarray(wno, np.float64)
    temps_flat, press_flat, nc_p = production_pt_grid()
    log_kappa = jnp.stack([_band_sigma_flat(m, wno, temps_flat, press_flat,
                                            seed=seed)
                           for m in molecules]).astype(dtype)

    continuum = ('H2H2', 'H2He')
    cia_temps = np.linspace(100, 3000, 10)
    cont = np.zeros((len(continuum), len(cia_temps), len(wno)), dtype)
    for im, mol in enumerate(continuum):
        rng = np.random.default_rng(zlib.crc32(mol.encode()))
        shape = 10 ** (-8 + 2 * np.sin(wno / wno.max() * 6
                                       + rng.uniform(0, 3)))
        for it, T in enumerate(cia_temps):
            cont[im, it] = shape * (T / 1000.0) ** 0.5

    t_offset = np.concatenate([[0], np.cumsum(nc_p)[:-1]]).astype(np.int32)
    temps = np.array(sorted(set(temps_flat)))
    # per-T pressure grids share the same log-spaced ladder; take the
    # longest row as the p_log_grid (shorter rows are guarded by nc_p)
    imax = int(np.argmax(nc_p))
    p_row = press_flat[t_offset[imax]:t_offset[imax] + nc_p[imax]]
    pt = PTGrid(t_inv_grid=jnp.asarray(1.0 / temps, dtype),
                p_log_grid=jnp.asarray(np.log10(p_row), dtype),
                nc_p=jnp.asarray(nc_p), t_offset=jnp.asarray(t_offset))
    return OpacityGrid(wno=jnp.asarray(wno),
                       log_kappa=jnp.asarray(log_kappa),
                       pt=pt, cont_opa=jnp.asarray(cont),
                       cia_temps=jnp.asarray(cia_temps, dtype),
                       molecules=tuple(molecules),
                       continuum_molecules=tuple(continuum))


# ---------------------------------------------------------------------------
# correlated-k table generation (offline tooling)
# ---------------------------------------------------------------------------

def compute_k_distribution(sigma, wno, bin_edges, gauss_pts):
    """k-coefficients per spectral bin from monochromatic cross sections.

    For each bin, the k-distribution is the quantile function of the
    cross-section values inside the bin evaluated at the g-point
    quadrature (the double-Gauss scheme of opacity_factory.py:1474).
    sigma: [..., nwno_mono]; returns [..., nbins, ngauss].
    """
    wno = np.asarray(wno)
    lead = sigma.shape[:-1]
    nbins = len(bin_edges) - 1
    out = np.zeros(lead + (nbins, len(gauss_pts)))
    for b in range(nbins):
        sel = (wno >= bin_edges[b]) & (wno < bin_edges[b + 1])
        if not sel.any():
            out[..., b, :] = 1e-50
            continue
        vals = np.sort(sigma[..., sel], axis=-1)
        n = vals.shape[-1]
        g = (np.arange(n) + 0.5) / n
        flat = vals.reshape(-1, n)
        kd = np.stack([np.interp(gauss_pts, g, row) for row in flat])
        out[..., b, :] = kd.reshape(lead + (len(gauss_pts),))
    return out


def compute_ck_molecular(mono_db, molecule, bin_edges, order=4, gfrac=0.95):
    """Per-molecule CK table from a reference-schema monochromatic sqlite
    (opacity_factory.py:1748 analog).

    Returns dict with kcoeffs [npress, ntemp, nbins, ngauss] (ln sigma),
    grids, and quadrature.
    """
    from .db import connect
    from .ck import double_gauss_points

    gauss_pts, gauss_wts = double_gauss_points(order, gfrac)
    cur, conn = connect(mono_db)
    cur.execute('SELECT wavenumber_grid FROM header')
    wno = cur.fetchone()[0]
    cur.execute('SELECT DISTINCT ptid, pressure, temperature FROM '
                'molecular WHERE molecule = ? ORDER BY ptid', (molecule,))
    pt = cur.fetchall()
    temps = np.unique([t for _, _, t in pt])
    pressures = np.unique([p for _, p, _ in pt])
    npress, ntemp = len(pressures), len(temps)
    nbins = len(bin_edges) - 1
    kco = np.zeros((npress, ntemp, nbins, len(gauss_pts)))
    cur.execute('SELECT ptid, pressure, temperature, opacity FROM '
                'molecular WHERE molecule = ?', (molecule,))
    for ptid, p, t, op in cur.fetchall():
        ip = int(np.searchsorted(pressures, p))
        it = int(np.searchsorted(temps, t))
        kco[ip, it] = compute_k_distribution(
            np.asarray(op)[None], wno, bin_edges, gauss_pts)[0]
    conn.close()
    centers = 0.5 * (np.asarray(bin_edges[1:]) + np.asarray(bin_edges[:-1]))
    return dict(kcoeffs=np.log(np.maximum(kco, 1e-50)),
                wno=centers, delta_wno=np.diff(bin_edges),
                pressures=pressures, temps=temps, gauss_pts=gauss_pts,
                gauss_wts=gauss_wts, molecule=molecule)


def compute_sum_molecular(mono_db, abundances, bin_edges, order=4,
                          gfrac=0.95):
    """Premixed CK table: abundance-weighted sum of cross sections,
    k-distributed per bin (opacity_factory.py:1530-1747
    ``compute_sum_molecular``).

    ``abundances`` is either a dict molecule -> vmr (scalar, applied at
    every grid point) or a chemistry-grid DataFrame with 'pressure' /
    'temperature' columns plus one column per molecule (e.g. the output
    of :func:`picaso_tpu.io_utils.read_visscher_2121`), in which case
    each (P, T) point mixes with the nearest chemistry row — the
    reference pathway (its chem_grid rows ride the 1460 grid).
    """
    import pandas as pd

    from .db import connect
    from .ck import double_gauss_points

    gauss_pts, gauss_wts = double_gauss_points(order, gfrac)
    cur, conn = connect(mono_db)
    cur.execute('SELECT wavenumber_grid FROM header')
    wno = cur.fetchone()[0]
    cur.execute('SELECT DISTINCT pressure, temperature FROM molecular')
    pt = cur.fetchall()
    temps = np.unique([t for _, t in pt])
    pressures = np.unique([p for p, _ in pt])

    per_pt = isinstance(abundances, pd.DataFrame)
    if per_pt:
        chem_logp = np.log10(np.maximum(
            np.asarray(abundances['pressure'], float), 1e-12))
        chem_tinv = 1.0 / np.asarray(abundances['temperature'], float)
        molecules = [c for c in abundances.keys()
                     if c not in ('pressure', 'temperature', 'index')]

        def vmr_at(mol, p, t):
            d = ((chem_logp - np.log10(max(p, 1e-12))) ** 2
                 + (chem_tinv * t - 1.0) ** 2)
            return float(abundances[mol].iloc[int(np.argmin(d))])
    else:
        molecules = list(abundances)

        def vmr_at(mol, p, t):
            return abundances[mol]

    mixed = np.zeros((len(pressures), len(temps), len(wno)))
    for mol in molecules:
        cur.execute('SELECT pressure, temperature, opacity FROM molecular '
                    'WHERE molecule = ?', (mol,))
        for p, t, op in cur.fetchall():
            ip = int(np.searchsorted(pressures, p))
            it = int(np.searchsorted(temps, t))
            mixed[ip, it] += vmr_at(mol, p, t) * np.asarray(op)
    conn.close()
    kco = compute_k_distribution(mixed, wno, bin_edges, gauss_pts)
    centers = 0.5 * (np.asarray(bin_edges[1:]) + np.asarray(bin_edges[:-1]))
    return dict(kcoeffs=np.log(np.maximum(kco, 1e-50)),
                wno=centers, delta_wno=np.diff(bin_edges),
                pressures=pressures, temps=temps, gauss_pts=gauss_pts,
                gauss_wts=gauss_wts)


def write_ck_hdf5(filename, ck, molecules, abunds):
    """Write a premixed CK table in the reference hdf5 format
    (get_ck_tables layout, opacity_factory.py:2221-2268).

    ``abunds``: dict molecule -> scalar vmr, or a chemistry DataFrame
    with per-(T, P) rows in T-major order matching the table grid.
    """
    import h5py
    import pandas as pd

    temps, pressures = ck['temps'], ck['pressures']
    npress, ntemp = len(pressures), len(temps)
    temps_flat = np.repeat(temps, npress)
    press_flat = np.tile(pressures, ntemp)
    if isinstance(abunds, pd.DataFrame):
        if len(abunds) != ntemp * npress:
            raise ValueError(f'chemistry table has {len(abunds)} rows; '
                             f'the CK grid needs {ntemp * npress}')
        abunds_arr = np.column_stack([np.asarray(abunds[m], float)
                                      for m in molecules])
    else:
        abunds_arr = np.column_stack([np.zeros(ntemp * npress) + abunds[m]
                                      for m in molecules])
    with h5py.File(filename, 'w') as f:
        f.create_dataset('ck_molecules',
                         data=[m.encode() for m in molecules])
        f.create_dataset('wno', data=ck['wno'])
        f.create_dataset('delta_wno', data=ck['delta_wno'])
        f.create_dataset('pressures', data=press_flat)
        f.create_dataset('temperatures', data=temps_flat)
        f.create_dataset('gauss_pts', data=ck['gauss_pts'])
        f.create_dataset('gauss_wts', data=ck['gauss_wts'])
        f.create_dataset('kcoeffs', data=ck['kcoeffs'])
        f.create_dataset('abunds', data=abunds_arr)
        f.create_dataset('abunds_map',
                         data=[m.encode() for m in molecules])
    return filename


def slice_db(src_db, dst_db, wave_range, molecules=None):
    """Write a narrow-wavelength slice of a reference-schema opacity DB.

    The production monochromatic databases are ~7 GB; a 0.5-0.7 um slice
    is tens of MB and drives the same golden-regression pipeline
    (tests/test_goldens.py runs against a slice exactly as against the
    full DB, asserting over the covered window).  ``wave_range`` is
    [min, max] in micron; ``molecules`` optionally restricts the species
    kept.  Continuum rows are sliced on the same window.
    """
    import sqlite3

    from .db import connect, _adapt_array

    cur, conn = connect(src_db)
    cur.execute('SELECT wavenumber_grid FROM header')
    wno = np.asarray(cur.fetchone()[0], float)
    cur.execute('SELECT pressure_unit, temperature_unit, continuum_unit, '
                'molecular_unit FROM header')
    units = cur.fetchone()
    wave = 1e4 / wno
    keep = (wave > min(wave_range)) & (wave < max(wave_range))
    if not keep.any():
        raise ValueError(f'no wavenumber points inside {wave_range} um')
    idx = np.where(keep)[0]

    sqlite3.register_adapter(np.ndarray, _adapt_array)
    out = sqlite3.connect(dst_db, detect_types=sqlite3.PARSE_DECLTYPES)
    oc = out.cursor()
    oc.execute('CREATE TABLE header (id INTEGER PRIMARY KEY, '
               'pressure_unit VARCHAR, temperature_unit VARCHAR, '
               'wavenumber_grid array, continuum_unit VARCHAR, '
               'molecular_unit VARCHAR)')
    oc.execute('INSERT INTO header (pressure_unit, temperature_unit, '
               'wavenumber_grid, continuum_unit, molecular_unit) '
               'VALUES (?,?,?,?,?)',
               (units[0], units[1], wno[idx], units[2], units[3]))
    oc.execute('CREATE TABLE molecular (id INTEGER PRIMARY KEY, '
               'molecule VARCHAR, ptid INTEGER, pressure FLOAT, '
               'temperature FLOAT, opacity array)')
    oc.execute('CREATE TABLE continuum (id INTEGER PRIMARY KEY, '
               'molecule VARCHAR, temperature FLOAT, opacity array)')

    if molecules is None:
        cur.execute('SELECT DISTINCT molecule FROM molecular')
        molecules = [x[0] for x in cur.fetchall()]
    for mol in molecules:
        cur.execute('SELECT ptid, pressure, temperature, opacity '
                    'FROM molecular WHERE molecule = ?', (mol,))
        rows = [(mol, ptid, p, t, np.asarray(op, float)[idx])
                for ptid, p, t, op in cur.fetchall()]
        oc.executemany('INSERT INTO molecular (molecule, ptid, pressure, '
                       'temperature, opacity) VALUES (?,?,?,?,?)', rows)
    cur.execute('SELECT molecule, temperature, opacity FROM continuum')
    crows = [(mol, t, np.asarray(op, float)[idx])
             for mol, t, op in cur.fetchall()]
    oc.executemany('INSERT INTO continuum (molecule, temperature, opacity)'
                   ' VALUES (?,?,?)', crows)
    out.commit()
    out.close()
    conn.close()
    return dst_db
