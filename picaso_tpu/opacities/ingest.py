"""Raw-source opacity ingestion: build production DBs from cross sections.

The offline front end of the opacity factory — the analog of the
reference's real-source paths (``opacity_factory.py:22-577`` continuum,
``:741-1260`` molecular inserts, ``:2060-2219`` metadata): parse raw CIA
ASCII grids / HITRAN CIA files / per-PT molecular cross-section archives,
fill the gaps with the published analytic continua (Linsky H2-H2, Bell
H2-, John H- bound-free, Bell & Berrington H- free-free), resample onto a
constant-R grid, and write the reference-schema sqlite databases that
:mod:`picaso_tpu.opacities.db` (and the reference itself) consume.

Pure host-side numpy/pandas — ingestion runs once, offline; the device never
sees these code paths.
"""

from __future__ import annotations

import glob
import json
import os
import sqlite3

import numpy as np
import pandas as pd

from ..refdata import refdata_path
from .db import connect, _adapt_array

__all__ = [
    'build_skeleton', 'insert_wno_grid', 'ingest_cia_grid',
    'ingest_hitran_cia', 'ingest_molecular_1060', 'ingest_molecular_1460',
    'h2h2_overtone', 'fit_linsky', 'h2minus_cx', 'hminus_bf', 'hminus_ff',
    'kark_ch4', 'optical_o3', 'add_metadata', 'get_metadata',
]

# cm^5/molecule^2 -> cm^-1 amagat^-2 (Loschmidt^2; Richard+2012 eqn 3)
_CM5_TO_AMAGAT2 = 1.385277e-39


# ---------------------------------------------------------------------------
# database skeleton / metadata (opacity_factory.py:622-691, :2060-2219)
# ---------------------------------------------------------------------------

def build_skeleton(db_f):
    """Create the empty header/molecular/continuum tables."""
    cur, conn = connect(db_f)
    cur.executescript(
        'DROP TABLE IF EXISTS header;'
        'CREATE TABLE header (id INTEGER PRIMARY KEY,'
        ' pressure_unit VARCHAR, temperature_unit VARCHAR,'
        ' wavenumber_grid array, continuum_unit VARCHAR,'
        ' molecular_unit VARCHAR);')
    cur.executescript(
        'DROP TABLE IF EXISTS molecular;'
        'CREATE TABLE molecular (id INTEGER PRIMARY KEY, ptid INTEGER,'
        ' molecule VARCHAR, pressure FLOAT, temperature FLOAT,'
        ' opacity array);')
    cur.executescript(
        'DROP TABLE IF EXISTS continuum;'
        'CREATE TABLE continuum (id INTEGER PRIMARY KEY, molecule VARCHAR,'
        ' temperature FLOAT, opacity array);')
    conn.commit()
    conn.close()


def insert_wno_grid(db_f, wno_grid):
    """Insert the header row (units + wavenumber grid) if not present."""
    cur, conn = connect(db_f)
    cur.execute('SELECT count(*) FROM header')
    if cur.fetchone()[0] == 0:
        cur.execute(
            'INSERT INTO header (pressure_unit, temperature_unit,'
            ' wavenumber_grid, continuum_unit, molecular_unit)'
            ' values (?,?,?,?,?)',
            ('bar', 'kelvin', np.asarray(wno_grid, np.float64),
             'cm-1 amagat-2', 'cm2/molecule'))
        conn.commit()
    conn.close()


def add_metadata(db_path, version=None, default=False, resolution=None,
                 wavemin=None, wavemax=None, zenodo_doi=None, **extra):
    """Create/refresh the metadata key-value table
    (opacity_factory.py:2152-2219 semantics)."""
    conn = sqlite3.connect(db_path)
    cur = conn.cursor()
    cur.execute("SELECT name FROM sqlite_master WHERE type='table' "
                "AND name='metadata'")
    if cur.fetchone() is None:
        cur.execute('CREATE TABLE metadata (key TEXT PRIMARY KEY, '
                    'value TEXT)')
    items = dict(extra)
    if version is not None:
        items['version'] = ('default_' if default else '') + str(version)
    for k, v in (('resolution', resolution), ('wavemin', wavemin),
                 ('wavemax', wavemax), ('zenodo', zenodo_doi)):
        if v is not None:
            items[k] = v
    for k, v in items.items():
        cur.execute('INSERT INTO metadata (key, value) VALUES (?, ?) '
                    'ON CONFLICT(key) DO UPDATE SET value=excluded.value',
                    (k, str(v)))
    conn.commit()
    conn.close()


def get_metadata(db_path):
    """All metadata key/value pairs plus available molecule lists."""
    out = []
    conn = sqlite3.connect(db_path)
    cur = conn.cursor()
    try:
        cur.execute('SELECT key, value FROM metadata')
        out = cur.fetchall()
    except sqlite3.Error:
        out = [('version', 'no metadata table (pre-v4 format)')]
    try:
        cur.execute('SELECT DISTINCT molecule FROM molecular')
        out.append(('molecules', sorted(x[0] for x in cur.fetchall())))
        cur.execute('SELECT DISTINCT molecule FROM continuum')
        out.append(('continuum', sorted(x[0] for x in cur.fetchall())))
    except sqlite3.Error:
        pass
    conn.close()
    return out


def molecular_avail(db_path):
    """Molecules present in a DB (opacity_factory.py molecular_avail)."""
    conn = sqlite3.connect(db_path)
    try:
        cur = conn.execute('SELECT DISTINCT molecule FROM molecular')
        return sorted(x[0] for x in cur.fetchall())
    finally:
        conn.close()


def continuum_avail(db_path):
    """Continuum absorbers present in a DB
    (opacity_factory.py continuum_avail)."""
    conn = sqlite3.connect(db_path)
    try:
        cur = conn.execute('SELECT DISTINCT molecule FROM continuum')
        return sorted(x[0] for x in cur.fetchall())
    finally:
        conn.close()


def delete_molecule(mol, db_path):
    """Drop one molecule's rows from a DB
    (opacity_factory.py delete_molecule), e.g. before re-inserting an
    updated line list.  Returns the number of rows removed."""
    conn = sqlite3.connect(db_path)
    try:
        cur = conn.execute('DELETE FROM molecular WHERE molecule = ?',
                           (mol,))
        conn.commit()
        conn.execute('VACUUM')
        return cur.rowcount
    finally:
        conn.close()


# ---------------------------------------------------------------------------
# analytic continuum sources
# ---------------------------------------------------------------------------

def h2h2_overtone(t, wno):
    """H2-H2 second-overtone CIA band near 0.8 um (tabulated;
    opacity_factory.py:365-391).  Returns (opacity, index, available)."""
    fname = refdata_path('opacities', 'H2H2_ov2_eq.tbl')
    df = pd.read_csv(fname, sep=r'\s+').set_index('wavenumber')
    temps = np.array([float(c) for c in df.columns])
    if t > temps.max():
        return np.nan, np.nan, False
    it = int(np.argmin(np.abs(temps - t)))
    loc = np.where((wno >= df.index.min()) & (wno <= df.index.max()))
    vals = 10 ** np.interp(wno[loc], df.index.values,
                           np.log10(df.iloc[:, it].values),
                           left=-33, right=-33)
    return vals, loc, True


def fit_linsky(t, wno, va=3):
    """Analytic H2-H2 CIA from Linsky (1969) / Lenzuni et al. (1991),
    Table 8 coefficients, filling bands absent from the tabulated grids
    (opacity_factory.py:393-440).  Returns cm^-1 amagat^-2."""
    sig0 = [4162.043, 8274.650, 12017.753][va - 1]
    d1, d2, d3 = [1.2750e5, 1.32e6, 1.32e6][va - 1], 2760.0, 0.40
    a1 = [-7.661, -9.70, -11.32][va - 1]
    a2, b1, b2 = 0.5725, 0.9376, 0.5616

    d = d3 * np.sqrt(d1 + d2 * t)
    a = 10 ** (a1 + a2 * np.log10(t))
    b = 10 ** (b1 + b2 * np.log10(t))
    aa = 4.0 / 13.0 * a / d * np.exp(1.5 * d / b)
    kappa = aa * wno * np.exp(-(wno - sig0) / b)
    below = wno < sig0
    kappa = np.where(
        below,
        a * d * wno * np.exp((wno - sig0) / 0.6952 / t)
        / ((wno - sig0) ** 2 + d * d), kappa)
    near = wno < sig0 + 1.5 * d
    kappa = np.where(near, a * d * wno / ((wno - sig0) ** 2 + d * d),
                     kappa)
    return kappa


def h2minus_cx(t, wno):
    """H2- free-free opacity, Bell (1980) Table 1, for T > 600 K
    (opacity_factory.py:442-479).  Returns cm^4/dyn (multiplied by
    n_H2 * n_e * k * T downstream in assemble.continuum_tau)."""
    fname = refdata_path('opacities', 'h2minus.csv')
    df = pd.read_csv(fname, skiprows=5, header=0).set_index('theta')
    wno_bell = 1e8 / df.columns.astype(float).values
    theta = 5040.0 / t
    it = int(np.argmin(np.abs(df.index.values - theta)))
    kappa_bell = df.values[it, :] * 1e-26
    return np.interp(wno, wno_bell, kappa_bell, left=1e-33, right=1e-33)


def hminus_bf(wno):
    """H- bound-free cross section, John (1988) polynomial fit
    (opacity_factory.py:481-508).  Returns cm^2."""
    coeff = [4.982, -34.194, 92.536, -118.858, 49.534, 152.519]
    lambda_0 = 1.6419
    wave = 1e4 / np.asarray(wno, np.float64)
    result = np.full(wave.shape, 1e-33)
    ok = wno > 1e4 / lambda_0
    x = np.sqrt(np.where(ok, 1.0 / wave - 1.0 / lambda_0, 0.0))
    f = np.zeros_like(wave)
    for c in coeff:
        f = f * x + c
    result = np.where(ok, (wave * x) ** 3 * f * 1e-18, result)
    return result


_HMFF_J1 = np.array([
    [0.0, 2483.346, -3449.889, 2200.040, -696.271, 88.283],
    [0.0, 285.827, -1158.382, 2427.719, -1841.400, 444.517],
    [0.0, -2054.291, 8746.523, -13651.105, 8624.970, -1863.864],
    [0.0, 2827.776, -11485.632, 16755.524, -10051.530, 2095.288],
    [0.0, -1341.537, 5303.609, -7510.494, 4400.067, -901.788],
    [0.0, 208.952, -812.939, 1132.738, -655.020, 132.985]])
_HMFF_J2 = np.array([
    [518.1021, 473.2636, -482.2089, 115.5291, 0.0, 0.0],
    [-734.8666, 1443.4137, -737.1616, 169.6374, 0.0, 0.0],
    [1021.1775, -1977.3395, 1096.8827, -245.649, 0.0, 0.0],
    [-479.0721, 922.3575, -521.1341, 114.243, 0.0, 0.0],
    [93.1373, -178.9275, 101.7963, -21.9972, 0.0, 0.0],
    [-6.4285, 12.3600, -7.0571, 1.5097, 0.0, 0.0]])


def hminus_ff(t, wno):
    """H- free-free cross section incl. stimulated emission, Bell &
    Berrington (1987) fit (opacity_factory.py:510-577).  cm^5."""
    wave = 1e4 / np.asarray(wno, np.float64)
    if t < 800:
        return np.zeros(wave.size) + 1e-60
    theta = 5040.0 / t
    longw = wave > 0.3645
    wave_c = np.maximum(wave, 0.1823)
    hj = np.zeros((6, wave.size))
    for i in range(6):
        A1, B1, C1, D1, E1, F1 = _HMFF_J1[:, i]
        A2, B2, C2, D2, E2, F2 = _HMFF_J2[:, i]
        w = wave_c
        long_val = 1e-29 * (w * w * A1 + B1 + (C1 + (D1 + (E1 + F1 / w)
                                                     / w) / w) / w)
        mid_val = 1e-29 * (w * w * A2 + B2 + (C2 + (D2 + (E2 + F2 / w)
                                                    / w) / w) / w)
        hj[i] = np.where(longw, long_val, mid_val)
    cx = sum(theta ** ((i + 1) / 2.0) * hj[i] for i in range(6))
    cx = np.where(wave > 20.0, 0.0, cx)   # fit invalid past 20 um
    return cx * 1.380658e-16 * t


def kark_ch4(kark_file, new_wno, t, current):
    """Karkoschka+2010 optical CH4, T-interpolated in log space, patched
    where the line lists have no coverage (opacity_factory.py:1107-1132).
    Returns (values, index)."""
    kappa = pd.read_csv(kark_file, sep=r'\s+', skiprows=2, header=None,
                        names=['nu', 'nm', '100', '198', '296', 'del/al'])
    kappa = kappa.loc[kappa['nm'] < 1000]
    z = (t - 198.0) / 98.9
    logKT = 10.0 ** (0.5 * z * (z - 1.0) * np.log10(kappa['100'].values)
                     + (1 - z ** 2.0) * np.log10(kappa['198'].values)
                     + 0.5 * z * (z + 1) * np.log10(kappa['296'].values))
    logKT = logKT / 71.80 * 1.6726219e-24 * 16   # km-am -> cm2/molecule
    loc = np.where((1e4 / new_wno < 1.0) & (current < 1e-60))
    return np.interp(new_wno[loc], kappa['nu'].values, logKT), loc


def optical_o3(file_o3, new_wno):
    """Optical ozone cross sections (MPI spectral atlas table;
    opacity_factory.py:1133-1149)."""
    df = pd.read_csv(file_o3, sep=r'\s+', names=['nm', 'cx'])
    wno_old = 1e4 / (df['nm'] * 1e-3).values[::-1]
    return np.interp(new_wno, wno_old, df['cx'].values[::-1],
                     left=1e-100, right=1e-100)


# ---------------------------------------------------------------------------
# continuum ingestion (opacity_factory.py:22-363)
# ---------------------------------------------------------------------------

def _parse_cia_ascii(original_file, colnames):
    """Parse the EGP-style CIA ASCII grid: a count line, then per-T blocks
    each led by a bare temperature line followed by (wno, log10 kappa...)
    rows.  Returns (data_frame, temperatures, old_wno)."""
    og = pd.read_csv(original_file, sep=r'\s+', names=colnames)
    temperatures = og['wno'].loc[np.isnan(og[colnames[1]])].values
    og = og.dropna()
    old_wno = og['wno'].unique()
    return og, temperatures, old_wno


def ingest_cia_grid(original_file, colnames, new_wno, new_db,
                    overwrite=False):
    """Build the continuum table from the master H2-based CIA ASCII grid,
    patching H2H2 with the overtone band + Linsky fill and adding the
    H2- / H-bf / H-ff analytic sources at every temperature
    (restruct_continuum + restructure_opacity,
    opacity_factory.py:22-60,:280-363)."""
    import scipy.signal as sig

    if _table_exists(new_db, 'continuum'):
        cur, conn = connect(new_db)
        cur.execute('SELECT count(*) FROM continuum')
        n = cur.fetchone()[0]
        conn.close()
        if n and not overwrite:
            raise FileExistsError(
                f'{new_db} already has {n} continuum rows; pass '
                'overwrite=True to rebuild')
    else:
        build_skeleton(new_db)

    new_wno = np.asarray(new_wno, np.float64)
    og, temperatures, old_wno = _parse_cia_ascii(original_file, colnames)
    molecules = colnames[1:]
    nwno_old = len(old_wno)

    dw = new_wno[1] - new_wno[0]
    kernel = int(np.ceil((10050 - 9960) / dw) // 2 * 2 + 1)

    cur, conn = connect(new_db)
    zero_bundle = np.zeros(len(new_wno)) + 1e-33
    hminusbf_cache = None
    for i, t in enumerate(temperatures):
        block = og.iloc[i * nwno_old:(i + 1) * nwno_old]
        for m in molecules:
            bundle = 10 ** np.interp(new_wno, old_wno, block[m].values,
                                     right=-33, left=-33)
            if m == 'H2H2':
                ov, loc, have = h2h2_overtone(t, new_wno)
                if have:
                    bundle[loc] = ov
                loc_33 = np.where((bundle == 1e-33) & (new_wno >= 1000))
                bundle[loc_33] = fit_linsky(t, new_wno[loc_33])
                if len(loc_33[0]) and (new_wno[loc_33] < 12000).max():
                    loc_s = np.where((new_wno > 9950) & (new_wno < 11200))
                    if len(loc_s[0]):
                        bundle[loc_s] = sig.medfilt(
                            np.array(bundle[loc_s]), kernel_size=kernel)
            cur.execute('INSERT INTO continuum (molecule, temperature, '
                        'opacity) values (?,?,?)', (m, float(t), bundle))

        cur.execute('INSERT INTO continuum (molecule, temperature, '
                    'opacity) values (?,?,?)',
                    ('H2-', float(t),
                     zero_bundle if t < 600.0
                     else h2minus_cx(t, new_wno)))
        if t < 800.0:
            bf, ff = zero_bundle, zero_bundle * 1e-30
        else:
            if hminusbf_cache is None:
                hminusbf_cache = hminus_bf(new_wno)
            bf, ff = hminusbf_cache, hminus_ff(t, new_wno)
        cur.execute('INSERT INTO continuum (molecule, temperature, '
                    'opacity) values (?,?,?)', ('H-bf', float(t), bf))
        cur.execute('INSERT INTO continuum (molecule, temperature, '
                    'opacity) values (?,?,?)', ('H-ff', float(t), ff))
    conn.commit()
    conn.close()


_HITRAN_FIELDS = {'chemical': (0, 20), 'wavenumber': (20, 40),
                  'num_pts': (40, 47), 'temp': (47, 54)}
# curated per-molecule choices: HITRAN files with overlapping T blocks
# need a common grid, and some pressure-tagged sets are skipped
HITRAN_CHOICES = {'N2N2': {'ignore_tag': ['0-10atm'],
                           'tgrid': list(np.arange(70.0, 401.0, 10.0))}}


def ingest_hitran_cia(original_file, molname, new_db, new_wno):
    """Add one HITRAN CIA file (hitran.org CIA format) as a continuum
    molecule on the temperatures already present in ``new_db``
    (insert_hitran_cia, opacity_factory.py:61-227)."""
    cur, conn = connect(new_db)
    cur.execute('SELECT temperature FROM continuum')
    cia_temps = np.unique(cur.fetchall())
    conn.close()
    if len(cia_temps) == 0:
        raise RuntimeError('continuum table is empty — ingest the master '
                           'H2 CIA grid first (ingest_cia_grid)')
    new_wno = np.asarray(new_wno, np.float64)

    with open(original_file) as f:
        lines = f.readlines()
    # a header line carries the chemical tag in its fixed-width field
    blocks = []      # (temp, header_line, wno[], cx[])
    i = 0
    while i < len(lines):
        header = lines[i]
        t = float(header[_HITRAN_FIELDS['temp'][0]:
                         _HITRAN_FIELDS['temp'][1]])
        n = int(header[_HITRAN_FIELDS['num_pts'][0]:
                       _HITRAN_FIELDS['num_pts'][1]])
        rows = [ln.split() for ln in lines[i + 1:i + 1 + n]]
        wno = np.array([float(r[0]) for r in rows])
        cx = np.array([float(r[1]) for r in rows])
        keep = cx > 0
        blocks.append((t, header, wno[keep], cx[keep]))
        i += 1 + n

    choices = HITRAN_CHOICES.get(molname, {})
    ignore = choices.get('ignore_tag', [])
    temp_arr, cx_arrays = [], []
    for t, header, wno, cx in blocks:
        if any(tag in header for tag in ignore):
            continue
        cx_arrays.append(10 ** np.interp(new_wno, wno, np.log10(cx),
                                         right=-100, left=-100))
        temp_arr.append(t)
    temp_arr = np.array(temp_arr)
    cx_arrays = np.array(cx_arrays)

    # segment on temperature restarts (multiple band systems)
    segs = np.diff(temp_arr)
    if (segs < 0).any():
        if 'tgrid' not in choices:
            raise ValueError(f'{molname}: overlapping temperature blocks; '
                             'provide a tgrid in HITRAN_CHOICES')
        tgrid = np.asarray(choices['tgrid'])
        inds = [0] + list(np.where(segs < 0)[0] + 1) + [len(temp_arr)]
        iranges = [(inds[i], inds[i + 1]) for i in range(len(inds) - 1)]
    else:
        tgrid = temp_arr
        iranges = [(0, len(temp_arr))]

    summed = np.zeros((len(cia_temps), len(new_wno)))
    for lo, hi in iranges:
        og_t = temp_arr[lo:hi]
        cx = cx_arrays[lo:hi]
        with np.errstate(divide='ignore'):
            logcx = np.log10(cx)
        if not np.array_equal(og_t, tgrid):
            # extrapolate each band onto the common grid first
            on_grid = np.stack([
                10 ** np.interp(tgrid, og_t, logcx[:, iw])
                for iw in range(len(new_wno))], axis=1)
            with np.errstate(divide='ignore'):
                log_on = np.log10(on_grid)
        else:
            log_on = logcx
        summed += np.stack([
            10 ** np.interp(cia_temps, tgrid, log_on[:, iw],
                            left=-100, right=-100)
            for iw in range(len(new_wno))], axis=1)

    cur, conn = connect(new_db)
    for it, t in enumerate(cia_temps):
        cur.execute('INSERT INTO continuum (molecule, temperature, '
                    'opacity) values (?,?,?)',
                    (molname, float(t), summed[it] / _CM5_TO_AMAGAT2))
    conn.commit()
    conn.close()


# ---------------------------------------------------------------------------
# molecular ingestion (opacity_factory.py:741-1260)
# ---------------------------------------------------------------------------

_ALKALIS = ('Na', 'K', 'Rb', 'Cs', 'Li')


def _table_exists(db, name):
    if not os.path.exists(db):
        return False
    conn = sqlite3.connect(db)
    cur = conn.cursor()
    cur.execute("SELECT name FROM sqlite_master WHERE type='table' AND "
                'name=?', (name,))
    out = cur.fetchone() is not None
    conn.close()
    return out


def _wave_layout(mol_dir, grid_df):
    """(numw, delwn, start) per PT file: from readomni.fits if present,
    else from the grid CSV's layout columns."""
    read_fits = os.path.join(mol_dir, 'readomni.fits')
    if os.path.exists(read_fits):
        from ..fits_lite import read_fits as read_fits_file
        table = read_fits_file(read_fits)[1][1]
        return (np.asarray(table['Valid rows']),
                np.asarray(table['Delta Wavenum']),
                np.asarray(table['Start Wavenum']))
    return (grid_df['number_wave_pts'].values.astype(int),
            grid_df['delta_wavenumber'].values.astype(float),
            grid_df['start_wavenumber'].values.astype(float))


def _detect_format(mol_dir, threshold=2):
    if os.path.exists(str(mol_dir) + '.h5'):
        return 'h5'
    counts = {
        'fortran_binary': len(glob.glob(os.path.join(mol_dir, '*p_*'))),
        'python': len(glob.glob(os.path.join(mol_dir, '*npy*'))),
        'lupu_txt': len(glob.glob(os.path.join(mol_dir, '*txt*'))),
        'rfree_fort': len(glob.glob(os.path.join(mol_dir, 'fort.*'))),
    }
    best = max(counts, key=counts.get)
    if counts[best] < threshold:
        raise FileNotFoundError(
            f'no cross-section files found under {mol_dir} '
            f'(want p_N binaries, N.npy, *txt, fort.N, or {mol_dir}.h5)')
    return best


def _read_pt_file(ftype, mol_dir, molecule, i, p, t, numw, delwn, start,
                  lupu_wave=None):
    """One PT point's (cross sections, native wavenumber grid)."""
    if ftype == 'lupu_txt':
        mbar = p * 1e3
        fdata = os.path.join(mol_dir, f'{molecule}_{mbar:.2e}mbar_'
                                      f'{t:.0f}K.txt')
        dset = pd.read_csv(fdata, skiprows=2, header=None).values[:, 0]
        wno = 1e4 / pd.read_csv(lupu_wave).iloc[:, 0].values
    elif ftype == 'alkali_csv':
        df = pd.read_csv(os.path.join(mol_dir, f'p_{i}'))
        wno = df['wno'].values.astype(float)
        dset = df[molecule].values.astype(float)
    elif ftype == 'fortran_binary':
        dset = np.fromfile(os.path.join(mol_dir, f'p_{i}'), dtype=float)
        wno = np.arange(numw[i - 1]) * delwn[i - 1] + start[i - 1]
    elif ftype == 'python':
        dset = np.load(os.path.join(mol_dir, f'{i}.npy'))
        wno = np.arange(numw[i - 1]) * delwn[i - 1] + start[i - 1]
    elif ftype == 'rfree_fort':
        df = pd.read_csv(os.path.join(mol_dir, f'fort.{i}'), sep=r'\s+',
                         skiprows=27, header=None, names=['wno', 'cx'])
        dset = df['cx'].values
        wno = df['wno'].values
    elif ftype == 'h5':
        import h5py
        with h5py.File(str(mol_dir) + '.h5', 'r') as f:
            dset = f['cxs'][i - 1]
        wno = np.arange(numw[i - 1]) * delwn[i - 1] + start[i - 1]
    else:
        raise ValueError(f'unknown source format {ftype!r}')
    return np.array(dset, np.float64), np.array(wno, np.float64)


def _ingest_molecular(molecule, grid_csv, min_wavelength, max_wavelength,
                      og_directory, new_db, new_R=None, new_dwno=None,
                      old_R=1e6, old_dwno=0.0035, alkali_dir='alkalis',
                      dir_kark_ch4=None, dir_optical_o3=None,
                      insert_direct=False, floor=1e-100):
    """Shared 1060/1460 molecular insert: read every PT file, interpolate
    onto the constant-R (or constant-dwno) working grid, stride-resample,
    apply the optical CH4/O3 patches, insert
    (opacity_factory.py:741-1056)."""
    from ..wavelength import create_grid

    if isinstance(new_R, (int, float)):
        interp_grid = create_grid(min_wavelength, max_wavelength, old_R)
        bins = int(old_R / new_R)
    elif isinstance(new_dwno, (int, float)):
        interp_grid = np.arange(1e4 / max_wavelength,
                                1e4 / min_wavelength, old_dwno)
        bins = int(new_dwno / old_dwno)
    elif insert_direct:
        interp_grid, bins = None, 1
    else:
        raise ValueError('need new_R, new_dwno, or insert_direct=True')

    grid_df = pd.read_csv(grid_csv, dtype=str)
    pres = grid_df['pressure_bar'].values.astype(float)
    temp = grid_df['temperature_K'].values.astype(float)
    ifile = grid_df['file_number'].values.astype(int)

    if molecule in _ALKALIS:
        if alkali_dir == 'alkalis':
            mol_dir = os.path.join(og_directory, 'alkalis')
        elif alkali_dir == 'individual_file':
            mol_dir = os.path.join(og_directory, molecule)
        else:
            mol_dir = alkali_dir
        ftype = 'alkali_csv'
    else:
        mol_dir = os.path.join(og_directory, molecule)
        ftype = _detect_format(mol_dir)
    lupu_wave = os.path.join(mol_dir, 'wavelengths.txt')
    numw = delwn = start = None
    if ftype in ('fortran_binary', 'python', 'h5'):
        numw, delwn, start = _wave_layout(mol_dir, grid_df)

    if not _table_exists(new_db, 'molecular'):
        build_skeleton(new_db)
    cur, conn = connect(new_db)
    new_grid = None
    for i, p, t in zip(ifile, pres, temp):
        dset, og_wno = _read_pt_file(ftype, mol_dir, molecule, int(i),
                                     p, t, numw, delwn, start,
                                     lupu_wave=lupu_wave)
        if not insert_direct:
            dset = np.interp(interp_grid, og_wno, dset, right=floor,
                             left=floor)
            dset[dset < floor] = floor
            y = dset[::bins]
            new_grid = interp_grid[::bins]
        else:
            sel = (1e4 / og_wno > min_wavelength) & \
                  (1e4 / og_wno < max_wavelength)
            dset[dset < floor] = floor
            y, new_grid = dset[sel], og_wno[sel]

        if molecule in ('CH4', '12C-H4') and dir_kark_ch4 and t < 500:
            vals, loc = kark_ch4(dir_kark_ch4, new_grid, t, y)
            y[loc] = vals
        if molecule == 'O3' and dir_optical_o3 and t < 500:
            y = y + optical_o3(dir_optical_o3, new_grid)
        cur.execute('INSERT INTO molecular (ptid, molecule, temperature, '
                    'pressure, opacity) values (?,?,?,?,?)',
                    (int(i), molecule, float(t), float(p), y))
    conn.commit()
    conn.close()
    insert_wno_grid(new_db, new_grid)
    return new_grid


def ingest_molecular_1060(molecule, min_wavelength, max_wavelength, new_R,
                          og_directory, new_db, **kwargs):
    """Resample one molecule's 1060-grid cross sections into ``new_db``
    (insert_molecular_1060, opacity_factory.py:741-848).  The source tree
    must contain grid1060.csv + per-molecule directories."""
    grid_csv = os.path.join(og_directory, 'grid1060.csv')
    return _ingest_molecular(molecule, grid_csv, min_wavelength,
                             max_wavelength, og_directory, new_db,
                             new_R=new_R, floor=1e-50, **kwargs)


def ingest_molecular_1460(molecule, min_wavelength, max_wavelength,
                          og_directory, new_db, new_R=None, new_dwno=None,
                          **kwargs):
    """Resample one molecule's 1460-grid cross sections into ``new_db``
    (insert_molecular_1460, opacity_factory.py:850-1056).  grid1460.csv
    comes from the source tree or the bundled refdata."""
    grid_csv = os.path.join(og_directory, 'grid1460.csv')
    if not os.path.exists(grid_csv):
        grid_csv = refdata_path('opacities', 'grid1460.csv')
    return _ingest_molecular(molecule, grid_csv, min_wavelength,
                             max_wavelength, og_directory, new_db,
                             new_R=new_R, new_dwno=new_dwno, **kwargs)


def kark_ch4_noT(kark_dir, new_wno, temperature=None):
    """Karkoschka+2010 optical CH4 WITHOUT temperature dependence
    (get_kark_CH4_noTdependence, opacity_factory.py:1058-1104): the
    published 10-nm band table (``kark_beers.csv``) tabulates a Beer-law
    coefficient every 2 nm; cells marked ``=`` instead carry 4-term
    exponential-sum fits (``kark_four_term.csv``), any other non-numeric
    marker a 2-term fit (``kark_two_term.csv``), each collapsed with the
    tabulated Gauss weights (``kark_gauss_weights.csv``).  ``temperature``
    is accepted for reference-signature parity and ignored (that is the
    point of this variant).  Returns cm2/molecule on ``new_wno``
    (1e-33 outside the table's coverage)."""
    del temperature
    beers = pd.read_csv(os.path.join(kark_dir, 'kark_beers.csv'),
                        sep=r'\s+')
    two = pd.read_csv(os.path.join(kark_dir, 'kark_two_term.csv'),
                      sep=r'\s+').set_index('wavelength(nm)')
    four = pd.read_csv(os.path.join(kark_dir, 'kark_four_term.csv'),
                       sep=r'\s+').set_index('wavelength(nm)')
    wts = pd.read_csv(os.path.join(kark_dir, 'kark_gauss_weights.csv'),
                      sep=r'\s+')
    w4 = wts.loc[wts['number'] == 4,
                 [str(i) for i in range(1, 5)]].values.ravel()
    w2 = wts.loc[wts['number'] == 2,
                 [str(i) for i in range(1, 3)]].values.ravel()
    sum4 = (four[['coef1', 'coef2', 'coef3', 'coef4']].values
            @ w4)
    sum4 = pd.Series(sum4, index=four.index)
    sum2 = pd.Series(two[['coef1', 'coef2']].values @ w2, index=two.index)

    wave_nm, kappa = [], []
    for _, row in beers.iterrows():
        base = float(row['wavelength(nm)'])
        for c in ('0', '2', '4', '6', '8'):
            iwave = base + float(c)
            wave_nm.append(iwave)
            try:
                kappa.append(float(row[c]))
            except (TypeError, ValueError):
                table = sum4 if str(row[c]) == '=' else sum2
                kappa.append(float(table.loc[iwave]))
    # km-amagat -> cm2/g -> cm2/molecule, ascending wavenumber
    kappa = np.asarray(kappa)[::-1] / 71.80 * 1.6726219e-24 * 16
    wno_kark = (1e4 / (np.asarray(wave_nm) * 1e-3))[::-1]
    return np.interp(new_wno, wno_kark, kappa, left=1e-33, right=1e-33)


def _rebin_fold(x, bins, reduce):
    """Fold ``x`` into rows of ``bins`` samples and reduce each row
    (vectorize_rebin_median / vectorize_rebin_mean,
    opacity_factory.py:1151-1174): a partial final row is reduced over
    its REAL samples only (the reference zero-pads then patches the last
    row; same result).  Also handles the exact-fold case, which the
    reference's off-by-one row count would crash on."""
    x = np.asarray(x, np.float64)
    mod = len(x) % bins
    if mod == 0:
        return reduce(x.reshape(-1, bins), axis=1)
    out = np.empty(len(x) // bins + 1)
    out[:-1] = reduce(x[:len(x) - mod].reshape(-1, bins), axis=1)
    out[-1] = reduce(x[len(x) - mod:])
    return out


def ingest_molecular_1060_median(molecule, min_wavelength, max_wavelength,
                                 new_R, og_directory, new_db,
                                 old_R=6e6, min_grid_wavelength=0.3,
                                 floor=1e-33):
    """Median-rebin variant of the 1060-grid resample
    (vresample_and_insert_molecular, opacity_factory.py:1174-1260): the
    source cross sections are interpolated onto a uniform-dwno hi-res
    working grid (dwno set by ``old_R`` at ``min_grid_wavelength``) and
    each output bin takes the MEDIAN of its samples, where the stride
    variant (:func:`ingest_molecular_1060`) takes every BIN'th point;
    the output wavenumber grid takes the bin means.  The reference marks
    this slower/equivalent — kept for tooling parity."""
    min_wno, max_wno = 1e4 / max_wavelength, 1e4 / min_wavelength
    dwno_new = 1e4 / (max_wavelength * new_R)
    dwno_old = 1e4 / (min_grid_wavelength * old_R)
    interp_grid = np.arange(min_wno, max_wno, dwno_old)
    bins = int(dwno_new / dwno_old)
    new_grid = _rebin_fold(interp_grid, bins, np.mean)

    grid_df = pd.read_csv(os.path.join(og_directory, 'grid1060.csv'),
                          dtype=str)
    pres = grid_df['pressure_bar'].values.astype(float)
    temp = grid_df['temperature_K'].values.astype(float)
    ifile = grid_df['file_number'].values.astype(int)
    mol_dir = os.path.join(og_directory, molecule)
    ftype = _detect_format(mol_dir)
    numw = delwn = start = None
    if ftype in ('fortran_binary', 'python', 'h5'):
        numw, delwn, start = _wave_layout(mol_dir, grid_df)

    if not _table_exists(new_db, 'molecular'):
        build_skeleton(new_db)
    cur, conn = connect(new_db)
    for i, p, t in zip(ifile, pres, temp):
        dset, og_wno = _read_pt_file(ftype, mol_dir, molecule, int(i),
                                     p, t, numw, delwn, start)
        dset = np.interp(interp_grid, og_wno, dset, right=floor,
                         left=floor)
        y = _rebin_fold(dset, bins, np.median)
        cur.execute('INSERT INTO molecular (ptid, molecule, temperature, '
                    'pressure, opacity) values (?,?,?,?,?)',
                    (int(i), molecule, float(t), float(p), y))
    conn.commit()
    conn.close()
    insert_wno_grid(new_db, new_grid)
    return new_grid
