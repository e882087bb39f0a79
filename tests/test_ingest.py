"""Opacity-factory ingestion A/B against the actual reference factory.

Synthetic *raw* inputs (EGP-format CIA ASCII grid, HITRAN CIA file,
per-PT .npy cross-section archives) are ingested by BOTH implementations
— picaso_tpu.opacities.ingest and the reference's opacity_factory (pure
pandas/numpy, imported via tests/refshim.py) — into reference-schema
sqlite DBs, and the resulting tables are compared numerically.  A final
round-trip runs a spectrum through opannection on the ingested DB.
"""

import os
import sys

import numpy as np
import pandas as pd
import pytest

sys.path.insert(0, os.path.dirname(__file__))

import refshim  # noqa: E402

from picaso_tpu.opacities import ingest  # noqa: E402
from picaso_tpu.opacities.db import connect  # noqa: E402

pytestmark = pytest.mark.skipif(
    not os.path.isdir(refshim.REFERENCE_REFDATA),
    reason='reference checkout not available')

CIA_COLS = ['wno', 'H2H2', 'H2He', 'H2H', 'H2CH4', 'H2N2']


@pytest.fixture(scope='module')
def raw_dir(tmp_path_factory):
    """Synthetic raw source tree: CIA ASCII + HITRAN CIA + npy molecules."""
    rng = np.random.default_rng(42)
    root = tmp_path_factory.mktemp('rawsrc')

    # --- EGP-format master CIA grid: count line, per-T blocks ---
    old_wno = np.arange(20.0, 15000.0, 40.0)
    temps = [200.0, 500.0, 1000.0, 1500.0]
    lines = [f'{len(old_wno)} {len(temps)}']
    for t in temps:
        lines.append(f'{t}')
        for w in old_wno:
            vals = [-7 - 3 * np.exp(-((w - c) / 2000.0) ** 2)
                    + 0.2 * np.log10(t / 500.0)
                    for c in (2000.0, 5000.0, 8000.0, 11000.0, 14000.0)]
            # leave a gap in H2H2 above 9000 cm-1 so the Linsky fill runs
            if w > 9000:
                vals[0] = -33.0
            lines.append('  '.join([f'{w:.1f}'] +
                                   [f'{v:.4f}' for v in vals]))
    cia_file = root / 'master_cia.dat'
    cia_file.write_text('\n'.join(lines) + '\n')

    # --- HITRAN CIA file (fixed-width headers + wno/cx rows) ---
    hitran_lines = []
    for t in (100.0, 200.0, 300.0):
        wno_h = np.arange(500.0, 3000.0, 25.0)
        cx = 1e-46 * np.exp(-((wno_h - 1500.0) / 600.0) ** 2) \
            * (t / 200.0) ** 0.7
        header = ('N2-N2'.ljust(20)
                  + f'{wno_h.min():10.3f}{wno_h.max():10.3f}'
                  + f'{len(wno_h):7d}' + f'{t:7.1f}'
                  + '   ref note')
        hitran_lines.append(header)
        hitran_lines += [f' {w:12.4f} {c:12.4e}'
                         for w, c in zip(wno_h, cx)]
    hitran_file = root / 'N2-N2_2018.cia'
    hitran_file.write_text('\n'.join(hitran_lines) + '\n')

    # --- molecular archive: grid csv + npy cross sections ---
    npt = 8
    temps_m = np.repeat([300.0, 700.0, 1200.0, 2000.0], 2)
    pres_m = np.tile([0.1, 10.0], 4)
    numw, delwn, start = 5000, 4.0, 300.0
    grid = pd.DataFrame({
        'file_number': np.arange(1, npt + 1),
        'temperature_K': temps_m, 'pressure_bar': pres_m,
        'number_wave_pts': numw, 'delta_wavenumber': delwn,
        'start_wavenumber': start})
    grid.to_csv(root / 'grid1460.csv', index=False)
    og_wno = np.arange(numw) * delwn + start
    import h5py
    for mol in ('H2O', 'CH4'):
        cxs = np.zeros((npt, numw))
        for i in range(1, npt + 1):
            c = rng.uniform(og_wno.min(), og_wno.max(), 6)
            s = 10 ** rng.uniform(-24, -21, 6)
            cxs[i - 1] = 1e-30 + sum(
                a / (1 + ((og_wno - cc) / 300.0) ** 2)
                for a, cc in zip(s, c)) * (temps_m[i - 1] / 1000.0)
        with h5py.File(root / f'{mol}.h5', 'w') as f:
            f.create_dataset('cxs', data=cxs)
    return str(root), np.asarray(old_wno), temps


@pytest.fixture(scope='module')
def ref_factory():
    return refshim.load_reference('opacity_factory')


def _fetch_continuum(db):
    cur, conn = connect(db)
    cur.execute('SELECT molecule, temperature, opacity FROM continuum '
                'ORDER BY molecule, temperature')
    rows = cur.fetchall()
    conn.close()
    return rows


def _fetch_molecular(db, mol):
    cur, conn = connect(db)
    cur.execute('SELECT ptid, temperature, pressure, opacity FROM '
                'molecular WHERE molecule=? ORDER BY ptid', (mol,))
    rows = cur.fetchall()
    conn.close()
    return rows


def test_cia_ingestion_matches_reference(raw_dir, ref_factory, tmp_path):
    root, _, _ = raw_dir
    new_wno = np.arange(50.0, 15000.0, 30.0)

    mine = str(tmp_path / 'mine.db')
    ingest.ingest_cia_grid(os.path.join(root, 'master_cia.dat'), CIA_COLS,
                           new_wno, mine)
    ingest.ingest_hitran_cia(os.path.join(root, 'N2-N2_2018.cia'), 'N2N2',
                             mine, new_wno)

    theirs = str(tmp_path / 'ref.db')
    ref_factory.build_skeleton(theirs)
    ref_factory.restruct_continuum(os.path.join(root, 'master_cia.dat'),
                                   CIA_COLS, new_wno, theirs,
                                   overwrite=False)
    ref_factory.insert_hitran_cia(os.path.join(root, 'N2-N2_2018.cia'),
                                  'N2N2', theirs, new_wno)

    rows_m = _fetch_continuum(mine)
    rows_r = _fetch_continuum(theirs)
    assert [(m, t) for m, t, _ in rows_m] == [(m, t) for m, t, _ in rows_r]
    for (m, t, a), (_, _, b) in zip(rows_m, rows_r):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=0,
                                   err_msg=f'{m} @ {t}K')
    # every expected source landed
    mols = {m for m, _, _ in rows_m}
    assert mols == set(CIA_COLS[1:]) | {'H2-', 'H-bf', 'H-ff', 'N2N2'}
    # the Linsky fill actually produced non-floor H2H2 opacity in the gap
    h2h2_hot = [a for m, t, a in rows_m if m == 'H2H2' and t == 1500.0][0]
    gap = (new_wno > 9500) & (new_wno < 11000)
    assert (h2h2_hot[gap] > 1e-33).all()


def test_molecular_ingestion_matches_reference(raw_dir, ref_factory,
                                               tmp_path):
    root, _, _ = raw_dir

    mine = str(tmp_path / 'mine_mol.db')
    for mol in ('H2O', 'CH4'):
        ingest.ingest_molecular_1460(mol, 0.7, 20.0, root, mine, new_R=1e4)

    theirs = str(tmp_path / 'ref_mol.db')
    ref_factory.build_skeleton(theirs)
    for mol in ('H2O', 'CH4'):
        ref_factory.insert_molecular_1460(mol, 0.7, 20.0, root, theirs,
                                          new_R=1e4)

    for mol in ('H2O', 'CH4'):
        rows_m = _fetch_molecular(mine, mol)
        rows_r = _fetch_molecular(theirs, mol)
        assert len(rows_m) == len(rows_r) == 8
        for (i, t, p, a), (i2, t2, p2, b) in zip(rows_m, rows_r):
            assert (i, t, p) == (i2, t2, p2)
            # the working grid construction differs by ~1e-13 (cumprod
            # vs scalar-loop geometric series), shifting a handful of
            # interpolation nodes
            np.testing.assert_allclose(a, b, rtol=1e-10)

    # matching header wavenumber grids (same length, ~1e-13 construction)
    grids = []
    for db in (mine, theirs):
        cur, conn = connect(db)
        cur.execute('SELECT wavenumber_grid FROM header')
        grids.append(cur.fetchone()[0])
        conn.close()
    assert len(grids[0]) == len(grids[1])
    np.testing.assert_allclose(grids[0], grids[1], rtol=1e-12)


def test_ingested_db_roundtrip_spectrum(raw_dir, tmp_path):
    """A DB built from raw cross sections runs end-to-end through
    opannection -> spectrum."""
    from picaso_tpu import justdoit as jdi

    root, _, _ = raw_dir
    db = str(tmp_path / 'full.db')
    for mol in ('H2O', 'CH4'):
        ingest.ingest_molecular_1460(mol, 0.7, 20.0, root, db, new_R=1e4)
    new_wno = None
    cur, conn = connect(db)
    cur.execute('SELECT wavenumber_grid FROM header')
    new_wno = cur.fetchone()[0]
    conn.close()
    ingest.ingest_cia_grid(os.path.join(root, 'master_cia.dat'), CIA_COLS,
                           new_wno, db)
    ingest.add_metadata(db, version='4.0-syn', resolution='1e4',
                        wavemin='0.7', wavemax='20',
                        zenodo_doi='10.5281/zenodo.synthetic')

    meta = dict(ingest.get_metadata(db))
    assert meta['version'] == '4.0-syn'
    assert 'H2O' in meta['molecules'] and 'H2H2' in meta['continuum']

    opa = jdi.opannection(filename_db=db, wave_range=[1, 10])
    case = jdi.inputs(calculation='browndwarf')
    case.phase_angle(0)
    case.gravity(gravity=200, gravity_unit=jdi.u.Unit('m/(s**2)'))
    case.atmosphere(filename=jdi.brown_dwarf_pt(), sep=r'\s+')
    df = case.spectrum(opa, calculation='thermal')
    th = np.asarray(df['thermal'])
    assert np.isfinite(th).all() and (th > 0).all()


def test_analytic_continuum_sources():
    """Spot checks of the analytic sources against their defining
    expressions at reference points."""
    wno = np.array([5000.0, 9000.0, 12000.0])
    lin = ingest.fit_linsky(1000.0, wno)
    assert (lin > 0).all() and np.isfinite(lin).all()
    bf = ingest.hminus_bf(np.array([4000.0, 7000.0, 20000.0]))
    # threshold at 1.6419 um: below-threshold wavenumbers get the floor
    assert bf[0] == 1e-33 and bf[1] > 0 and bf[2] > 0
    ff800 = ingest.hminus_ff(799.0, wno)
    assert (ff800 == 1e-60).all()
    ff = ingest.hminus_ff(3000.0, wno)
    assert (ff > 0).all()


def test_db_utility_helpers(tmp_path):
    """molecular_avail / continuum_avail / delete_molecule
    (opacity_factory.py utility surface)."""
    import numpy as np

    from picaso_tpu.opacities import ingest
    from picaso_tpu.opacities.factory import build_synthetic_db

    db = str(tmp_path / 'util.db')
    build_synthetic_db(db, np.linspace(1000, 5000, 40),
                       molecules=('H2O', 'CH4', 'CO'))
    assert ingest.molecular_avail(db) == ['CH4', 'CO', 'H2O']
    assert 'H2H2' in ingest.continuum_avail(db)
    n = ingest.delete_molecule('CO', db)
    assert n > 0
    assert ingest.molecular_avail(db) == ['CH4', 'H2O']


def test_create_grid_minR_matches_reference(ref_factory):
    from picaso_tpu.wavelength import create_grid_minR
    grid, dwno = create_grid_minR(1.0, 5.0, 5000.0)
    grid_r, dwno_r = ref_factory.create_grid_minR(1.0, 5.0, 5000.0)
    assert dwno == pytest.approx(dwno_r, rel=1e-14)
    np.testing.assert_allclose(grid, grid_r, rtol=1e-14)
    # pinned behavior: R = wno/dwno equals minimum_R at the BLUE end and
    # falls redward (the reference's "all_Rs>R" docstring is not what
    # its own arithmetic does — behavior, not docstring, is matched)
    assert grid.max() / dwno == pytest.approx(5000.0, rel=1e-3)
    assert (grid / dwno).min() == pytest.approx(5000.0 / 5.0, rel=1e-2)


@pytest.fixture(scope='module')
def kark_dir(tmp_path_factory):
    """Synthetic Karkoschka band-model tables in the published layout."""
    root = tmp_path_factory.mktemp('kark')
    rng = np.random.default_rng(7)
    bases = np.arange(520.0, 600.0, 10.0)
    beers_rows = ['wavelength(nm) 0 2 4 6 8']
    four_rows = ['wavelength(nm) coef1 coef2 coef3 coef4']
    two_rows = ['wavelength(nm) coef1 coef2']
    for k, b in enumerate(bases):
        cells = []
        for j, c in enumerate((0.0, 2.0, 4.0, 6.0, 8.0)):
            iw = b + c
            kind = (k + j) % 3
            if kind == 0:
                cells.append(f'{rng.uniform(0.01, 2.0):.4f}')
            elif kind == 1:
                cells.append('=')
                four_rows.append(
                    f'{iw:.1f} ' + ' '.join(
                        f'{v:.5f}' for v in rng.uniform(0.01, 1.0, 4)))
            else:
                cells.append('*')
                two_rows.append(
                    f'{iw:.1f} ' + ' '.join(
                        f'{v:.5f}' for v in rng.uniform(0.01, 1.0, 2)))
        beers_rows.append(f'{b:.1f} ' + ' '.join(cells))
    (root / 'kark_beers.csv').write_text('\n'.join(beers_rows) + '\n')
    (root / 'kark_four_term.csv').write_text('\n'.join(four_rows) + '\n')
    (root / 'kark_two_term.csv').write_text('\n'.join(two_rows) + '\n')
    (root / 'kark_gauss_weights.csv').write_text(
        'number 1 2 3 4\n'
        '2 0.6 0.4 0 0\n'
        '4 0.35 0.3 0.2 0.15\n')
    return str(root)


def test_kark_ch4_noT_matches_reference(kark_dir, ref_factory):
    new_wno = np.linspace(1e4 / 0.61, 1e4 / 0.50, 400)
    mine = ingest.kark_ch4_noT(kark_dir, new_wno, 296.0)
    theirs = ref_factory.get_kark_CH4_noTdependence(kark_dir, new_wno,
                                                    296.0)
    np.testing.assert_allclose(mine, np.asarray(theirs, float),
                               rtol=1e-12)
    assert mine.min() > 0


@pytest.fixture(scope='module')
def tree_1060(tmp_path_factory):
    """Synthetic 1060-format source tree: fortran-binary p_N files +
    grid1060.csv (our layout source) + PTgrid1060.txt (the reference's)."""
    root = tmp_path_factory.mktemp('raw1060')
    rng = np.random.default_rng(5)
    npt = 6
    temps = np.repeat([300.0, 900.0, 1800.0], 2)
    pres = np.tile([0.5, 50.0], 3)
    numw, delwn, start = 120000, 0.01, 4000.0
    pd.DataFrame({
        'file_number': np.arange(1, npt + 1),
        'temperature_K': temps, 'pressure_bar': pres,
        'number_wave_pts': numw, 'delta_wavenumber': delwn,
        'start_wavenumber': start}).to_csv(root / 'grid1060.csv',
                                           index=False)
    (root / 'PTgrid1060.txt').write_text(
        'i pressure temperature\n' + '\n'.join(
            f'{i + 1} {p} {t}' for i, (p, t) in
            enumerate(zip(pres, temps))) + '\n')
    og_wno = np.arange(numw) * delwn + start
    mol_dir = root / 'CH4'
    mol_dir.mkdir()
    for i in range(1, npt + 1):
        c = rng.uniform(og_wno.min(), og_wno.max(), 5)
        cx = 1e-30 + sum(
            a / (1 + ((og_wno - cc) / 20.0) ** 2)
            for a, cc in zip(10 ** rng.uniform(-24, -22, 5), c))
        cx.astype(np.float64).tofile(mol_dir / f'p_{i}')
    layout = {'Valid rows': np.full(npt, numw),
              'Delta Wavenum': np.full(npt, delwn),
              'Start Wavenum': np.full(npt, start)}
    return str(root), layout


def test_median_resample_matches_reference(tree_1060, ref_factory,
                                           tmp_path):
    """ingest_molecular_1060_median vs the reference's
    vresample_and_insert_molecular (opacity_factory.py:1174), with the
    reference's astropy.io.fits.open (stubbed by refshim) served the
    same wave layout our path reads from grid1060.csv."""
    import types as _types
    root, layout = tree_1060

    mine = str(tmp_path / 'mine_med.db')
    new_grid = ingest.ingest_molecular_1060_median(
        'CH4', 2.0, 2.3, 2000.0, root, mine)

    theirs = str(tmp_path / 'ref_med.db')
    ref_factory.build_skeleton(theirs)
    orig_open = ref_factory.fits.open
    try:
        ref_factory.fits.open = lambda path: [
            None, _types.SimpleNamespace(data=layout)]
        new_grid_r = ref_factory.vresample_and_insert_molecular(
            'CH4', 2.0, 2.3, 2000.0, root, theirs)
    finally:
        ref_factory.fits.open = orig_open

    np.testing.assert_allclose(new_grid, np.asarray(new_grid_r),
                               rtol=1e-12)
    rows_m = _fetch_molecular(mine, 'CH4')
    rows_r = _fetch_molecular(theirs, 'CH4')
    assert len(rows_m) == len(rows_r) == 6
    for (i, t, p, a), (i2, t2, p2, b) in zip(rows_m, rows_r):
        assert (i, float(t), float(p)) == (i2, float(t2), float(p2))
        np.testing.assert_allclose(a, b, rtol=1e-12)
