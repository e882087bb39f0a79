"""Correlated-k opacity tables (premixed + per-gas), on device.

Replaces the reference ``RetrieveCKs`` (``optics.py:654-1875``): the premixed
kappa cube [npress, ntemp, nwno, ngauss] loads once into device memory; the bilinear
(1/T, log10 P) interpolation on ln-kappa (``get_pre_mix_ck``,
optics.py:1081-1161) and the CIA log-interp in inverse temperature
(``get_continuum``, optics.py:1398-1498) run on device inside jit, so every
climate iteration's opacity update is pure device work.

The chemistry table (``full_abunds``) rides along with the CK file exactly
as in the reference, feeding :mod:`picaso_tpu.chemistry` for the per-
iteration abundance refresh.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd

from ..refdata import refdata_path
from .db import connect

__all__ = ['CKArrays', 'CKTable', 'load_ck_db', 'synthetic_ck_table',
           'interp_premix', 'ck_continuum', 'double_gauss_points']

AVOGADRO = 6.02214086e+23


@jax.tree_util.register_pytree_node_class
class CKArrays(NamedTuple):
    """Device-resident CK data (a registered pytree; names are static)."""
    wno: jnp.ndarray            # [nwno]
    delta_wno: jnp.ndarray      # [nwno]
    gauss_wts: jnp.ndarray      # [ngauss]
    ln_kappa: jnp.ndarray       # [npress, ntemp, nwno, ngauss] (premixed)
    p_log_grid: jnp.ndarray     # [npress] log10 bar
    t_inv_grid: jnp.ndarray     # [ntemp] 1/K
    nc_p: jnp.ndarray           # [ntemp]
    cont_opa: jnp.ndarray       # [ncont, ntcia, nwno]
    cia_temps: jnp.ndarray      # [ntcia] sorted
    continuum_molecules: tuple  # static

    def tree_flatten(self):
        return (tuple(self)[:-1], (self.continuum_molecules,))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)


class CKTable:
    """Host-side CK connection: device arrays + chemistry table metadata."""

    def __init__(self, arrays: CKArrays, molecules, full_abunds: pd.DataFrame,
                 gauss_pts, temps, pressures, per_gas=None,
                 per_gas_molecules=None, wno=None, delta_wno=None,
                 gauss_wts=None):
        # optional per-gas ln-k tables [ngas, npress, ntemp, nwno, ngauss]
        # for on-the-fly resort-rebin mixing (disequilibrium chemistry)
        self.per_gas = per_gas
        self.per_gas_molecules = (tuple(per_gas_molecules)
                                  if per_gas_molecules else ())
        self.arrays = arrays
        self.molecules = tuple(molecules)
        self.full_abunds = full_abunds      # includes pressure/temperature
        self.gauss_pts = np.asarray(gauss_pts)
        self.temps = np.asarray(temps)
        self.pressures = np.asarray(pressures)
        # callers pass the host copies of the device arrays when they have
        # them, so table construction needs no device->host readback
        self.gauss_wts = np.asarray(arrays.gauss_wts if gauss_wts is None
                                    else gauss_wts)
        self.wno = np.asarray(arrays.wno if wno is None else wno)
        self.delta_wno = np.asarray(arrays.delta_wno if delta_wno is None
                                    else delta_wno)
        self.nwno = len(self.wno)
        self.ngauss = len(self.gauss_wts)
        self.continuum_molecules = arrays.continuum_molecules


def double_gauss_points(order=4, gfrac=0.95):
    """8-point double-Gauss quadrature used by the CK tables.

    Two Gauss-Legendre sets covering [0, gfrac] and [gfrac, 1]
    (opacity_factory.py:1474 g_w_2gauss semantics).
    """
    x, w = np.polynomial.legendre.leggauss(order)
    pts1 = gfrac * 0.5 * (x + 1.0)
    wts1 = gfrac * 0.5 * w
    pts2 = gfrac + (1 - gfrac) * 0.5 * (x + 1.0)
    wts2 = (1 - gfrac) * 0.5 * w
    return np.concatenate([pts1, pts2]), np.concatenate([wts1, wts2])


def _load_continuum(continuum_db, wno, dtype=np.float32):
    """Continuum table [ncont, ntemp, nwno] from the CK continuum sqlite."""
    cur, conn = connect(continuum_db)
    cur.execute('SELECT wavenumber_grid FROM header')
    db_wno = cur.fetchone()[0]
    if not (len(db_wno) == len(wno) and np.allclose(db_wno, wno)):
        raise ValueError('continuum DB wavenumber grid does not match the '
                         f'CK table grid ({len(db_wno)} vs {len(wno)} pts)')
    cur.execute('SELECT molecule FROM continuum')
    mols = sorted(set(x[0] for x in cur.fetchall()))
    cur.execute('SELECT temperature FROM continuum')
    temps = np.unique([x[0] for x in cur.fetchall()])
    # floored at the DB's own 1e-33 convention: exact zeros (H-ff, H2H2
    # rows of the bundled table) would give log(0) = -inf in the 1/T
    # log-interp, and 0 * -inf = NaN whenever a layer temperature lands
    # exactly on a grid node (e.g. a clipped isothermal guess)
    cont = np.zeros((len(mols), len(temps), len(wno)), dtype)
    for im, mol in enumerate(mols):
        cur.execute('SELECT temperature, opacity FROM continuum '
                    'WHERE molecule = ?', (mol,))
        for t, op in cur.fetchall():
            cont[im, int(np.searchsorted(temps, t))] = op
    conn.close()
    return np.maximum(cont, np.asarray(1e-33, dtype)), temps, tuple(mols)


def load_ck_db(ck_db, method='preweighted', continuum_db=None,
               dtype=np.float32, **kwargs):
    """Load a CK table.

    method='preweighted': premixed hdf5 (reference get_ck_tables format)
    or the legacy 1460-grid ASCII directory (optics.py:768-1058).
    method='resortrebin': a directory of per-gas <mol>_1460.hdf5 tables
    (opacity_factory.py:2280); molecular k-coefficients are then mixed
    on the fly from each atmosphere's abundances (gasesfly,
    optics.py:1164-1198).  kwargs: preload_gases (list, required).
    """
    if method == 'resortrebin':
        return _load_per_gas_ck(ck_db, kwargs.get('preload_gases'),
                                continuum_db, dtype)
    if (os.path.isdir(ck_db)
            or os.path.basename(str(ck_db)) == 'ascii_data'):
        return _load_legacy_ck(ck_db, continuum_db, dtype)
    import h5py
    with h5py.File(ck_db, 'r') as f:
        molecules = [x.decode('utf-8') for x in f['ck_molecules'][:]]
        wno = f['wno'][:]
        delta_wno = f['delta_wno'][:]
        pressures_flat = f['pressures'][:]
        temps_flat = f['temperatures'][:]
        gauss_pts = f['gauss_pts'][:]
        gauss_wts = f['gauss_wts'][:]
        kappa = f['kcoeffs'][:]       # [npress, ntemp, nwno, ngauss], ln
        abunds = pd.DataFrame(data=f['abunds'][:],
                              columns=[x.decode('utf-8')
                                       for x in f['abunds_map'][:]])
    abunds['temperature'] = temps_flat
    abunds['pressure'] = pressures_flat
    nc_p = abunds.groupby('temperature').size().astype(int).values
    temps = np.unique(temps_flat)
    pressures = np.unique(pressures_flat)

    if continuum_db is None:
        continuum_db = refdata_path('opacities', 'ck_cx_cont_opacities.db')
    cont, cia_temps, cont_mols = _load_continuum(continuum_db, wno, dtype)

    p_pos = pressures[pressures > 0]
    arrays = CKArrays(
        wno=jnp.asarray(wno), delta_wno=jnp.asarray(delta_wno),
        gauss_wts=jnp.asarray(gauss_wts, dtype),
        ln_kappa=jnp.asarray(kappa, dtype),
        p_log_grid=jnp.asarray(np.log10(p_pos), dtype),
        t_inv_grid=jnp.asarray(1.0 / temps, dtype),
        nc_p=jnp.asarray(nc_p, jnp.int32),
        cont_opa=jnp.asarray(cont),
        cia_temps=jnp.asarray(cia_temps, dtype),
        continuum_molecules=cont_mols)
    return CKTable(arrays, molecules, abunds, gauss_pts, temps,
                   pressures, wno=wno, delta_wno=delta_wno,
                   gauss_wts=gauss_wts)


def _load_per_gas_ck(ck_db, preload_gases, continuum_db, dtype):
    """CKTable in gasesfly mode from per-gas hdf5 tables.

    The premixed baseline cube is a solar-abundance kappa-space sum of
    the per-gas tables (used only where no atmosphere abundances are
    available); spectra and climate runs resort-rebin per layer.
    """
    from .resortrebin import load_per_gas_tables

    if not preload_gases:
        raise ValueError("method='resortrebin' needs preload_gases=[...]")
    per_gas, meta = load_per_gas_tables(ck_db, preload_gases, dtype)
    loaded = [m for m in preload_gases
              if os.path.exists(os.path.join(ck_db, f'{m}_1460.hdf5'))]
    solar = {'H2O': 1e-3, 'CH4': 5e-4, 'CO': 3e-4, 'NH3': 1e-4,
             'CO2': 1e-7, 'H2S': 3e-5}
    w = np.array([solar.get(m, 1e-5) for m in loaded], dtype)
    premix = np.log(np.einsum(
        'g,gptwk->ptwk', w, np.exp(np.asarray(per_gas))) + 1e-300)

    wno = np.asarray(meta['wno'], float)
    temps = np.asarray(meta['temps'], float)
    pressures = np.asarray(meta['pressures'], float)
    rows = [{m: solar.get(m, 1e-5) for m in loaded}
            | {'H2': 0.837, 'He': 0.155, 'temperature': T, 'pressure': P}
            for T in temps for P in pressures]
    abunds = pd.DataFrame(rows)

    if continuum_db is None:
        continuum_db = refdata_path('opacities', 'ck_cx_cont_opacities.db')
    cont, cia_temps, cont_mols = _load_continuum(continuum_db, wno, dtype)
    arrays = CKArrays(
        wno=jnp.asarray(wno), delta_wno=jnp.asarray(meta['delta_wno']),
        gauss_wts=jnp.asarray(meta['gauss_wts'], dtype),
        ln_kappa=jnp.asarray(premix, dtype),
        p_log_grid=jnp.asarray(np.log10(pressures[pressures > 0]), dtype),
        t_inv_grid=jnp.asarray(1.0 / temps, dtype),
        nc_p=jnp.asarray(meta['nc_p'], jnp.int32),
        cont_opa=jnp.asarray(cont),
        cia_temps=jnp.asarray(cia_temps, dtype),
        continuum_molecules=cont_mols)
    return CKTable(arrays, loaded, abunds, meta['gauss_pts'], temps,
                   pressures, per_gas=jnp.asarray(per_gas),
                   per_gas_molecules=loaded, wno=wno,
                   delta_wno=meta['delta_wno'],
                   gauss_wts=meta['gauss_wts'])


def _load_legacy_ck(ck_db, continuum_db, dtype):
    """CKTable from a legacy 1460-grid ASCII table (opacities/legacy.py)."""
    from .legacy import load_legacy_ck_1460

    leg = load_legacy_ck_1460(ck_db)
    wno = np.asarray(leg['wno'], float)
    kappa_ln = np.asarray(leg['kappa'], float) * np.log(10.0)
    pressures_flat = leg['pressures']
    temps = np.asarray(leg['temps'], float)
    p_pos = np.unique(pressures_flat[pressures_flat > 0])
    keep = pressures_flat > 0
    abunds = pd.DataFrame(
        np.asarray(leg['abunds'])[keep, :len(leg['molecules'])],
        columns=leg['molecules'])
    abunds['pressure'] = leg['pressure_labels']
    abunds['temperature'] = leg['temperature_labels']
    nc_p = np.asarray(leg['nc_p'], int)

    if continuum_db is None:
        continuum_db = refdata_path('opacities', 'ck_cx_cont_opacities.db')
    cont, cia_temps, cont_mols = _load_continuum(continuum_db, wno, dtype)
    arrays = CKArrays(
        wno=jnp.asarray(wno), delta_wno=jnp.asarray(leg['delta_wno']),
        gauss_wts=jnp.asarray(leg['gauss_wts'], dtype),
        ln_kappa=jnp.asarray(kappa_ln, dtype),
        p_log_grid=jnp.asarray(np.log10(p_pos), dtype),
        t_inv_grid=jnp.asarray(1.0 / temps, dtype),
        nc_p=jnp.asarray(nc_p, jnp.int32),
        cont_opa=jnp.asarray(cont),
        cia_temps=jnp.asarray(cia_temps, dtype),
        continuum_molecules=cont_mols)
    return CKTable(arrays, leg['molecules'], abunds, leg['gauss_pts'],
                   temps, p_pos, wno=wno, delta_wno=leg['delta_wno'],
                   gauss_wts=leg['gauss_wts'])


def synthetic_ck_table(continuum_db=None, molecules=('H2O', 'CH4', 'CO',
                                                     'NH3'),
                       ntemp=10, npress=10, seed=7, dtype=np.float32,
                       with_per_gas=False, grid661=False):
    """Synthetic premixed CK table on the 196-point EGP grid.

    Built from the same band-structured synthetic cross sections as the
    monochromatic factory, with a small spread across gauss points; the
    bundled real CK continuum database supplies the CIA.  Produces a
    solar-ish full_abunds chemistry table.

    ``grid661=True`` builds the table on the 661-bin climate grid
    (climate_INPUTS/wvno_661, the reference's other production climate
    resolution — optics.py:1390-1395), with the bundled 196-grid CIA
    row-interpolated onto it (synthetic-bench fidelity, not a data
    product).
    """
    from .factory import synthetic_cross_sections

    if continuum_db is None:
        continuum_db = refdata_path('opacities', 'ck_cx_cont_opacities.db')
    cur, conn = connect(continuum_db)
    cur.execute('SELECT wavenumber_grid FROM header')
    wno = cur.fetchone()[0]
    conn.close()
    if grid661:
        from ..wavelength import get_cld_input_grid
        wno = np.sort(np.asarray(get_cld_input_grid(grid661=True),
                                 np.float64))
    delta_wno = np.zeros(len(wno))
    delta_wno[1:-1] = 0.5 * (wno[2:] - wno[:-2])
    delta_wno[0] = wno[1] - wno[0]
    delta_wno[-1] = wno[-1] - wno[-2]

    temps = np.linspace(100, 3200, ntemp)
    pressures = np.logspace(-6, 3, npress)
    gauss_pts, gauss_wts = double_gauss_points()
    ngauss = len(gauss_pts)

    # premixed kappa: solar-ish abundance-weighted sum of synthetic sigmas
    mix_solar = {'H2O': 1e-3, 'CH4': 5e-4, 'CO': 3e-4, 'NH3': 1e-4,
                 'CO2': 1e-7, 'H2S': 3e-5}
    sigma_sum = 0.0
    for mol in molecules:
        sig = synthetic_cross_sections(mol, wno, temps, pressures, seed=seed)
        sigma_sum = sigma_sum + mix_solar.get(mol, 1e-5) * sig
    # [ntemp, npress, nwno] -> [npress, ntemp, nwno, ngauss] with a weak
    # gauss-point spread mimicking the k-distribution within each bin
    base = np.log(np.maximum(sigma_sum, 1e-50)).transpose(1, 0, 2)
    spread = np.linspace(-1.5, 2.5, ngauss)
    ln_kappa = base[..., None] + spread[None, None, None, :]

    # chemistry table at every (T, P) grid point (row order: T-major)
    rows = []
    for T in temps:
        for P in pressures:
            rows.append({'H2': 0.837, 'He': 0.155,
                         'H2O': mix_solar['H2O'] * min(1.0, (T / 1500.0)),
                         'CH4': mix_solar['CH4'] * min(1.0, (2000.0 / T)),
                         'CO': mix_solar['CO'] * min(1.0, (T / 1300.0) ** 2),
                         'NH3': mix_solar['NH3'] * min(1.0, (900.0 / T) ** 2),
                         'N2': 1e-5, 'temperature': T, 'pressure': P})
    abunds = pd.DataFrame(rows)

    if grid661:
        cur, conn = connect(continuum_db)
        cur.execute('SELECT wavenumber_grid FROM header')
        wno196 = cur.fetchone()[0]
        conn.close()
        cont196, cia_temps, cont_mols = _load_continuum(
            continuum_db, wno196, dtype)
        cont = np.zeros(cont196.shape[:2] + (len(wno),), dtype)
        for im in range(cont196.shape[0]):
            for it in range(cont196.shape[1]):
                cont[im, it] = np.interp(wno, wno196, cont196[im, it])
    else:
        cont, cia_temps, cont_mols = _load_continuum(continuum_db, wno,
                                                     dtype)
    arrays = CKArrays(
        wno=jnp.asarray(wno), delta_wno=jnp.asarray(delta_wno),
        gauss_wts=jnp.asarray(gauss_wts, dtype),
        ln_kappa=jnp.asarray(ln_kappa, dtype),
        p_log_grid=jnp.asarray(np.log10(pressures), dtype),
        t_inv_grid=jnp.asarray(1.0 / temps, dtype),
        nc_p=jnp.asarray(np.full(ntemp, npress), jnp.int32),
        cont_opa=jnp.asarray(cont),
        cia_temps=jnp.asarray(cia_temps, dtype),
        continuum_molecules=cont_mols)
    per_gas = None
    if with_per_gas:
        # per-gas tables consistent with the same synthetic cross sections
        # (same band structure, per-molecule, no premixing)
        ngauss_ = len(gauss_pts)
        spread = np.linspace(-1.5, 2.5, ngauss_)
        per_gas = np.zeros((len(molecules), npress, ntemp, len(wno),
                            ngauss_), dtype)
        for ig, mol in enumerate(molecules):
            sig = synthetic_cross_sections(mol, wno, temps, pressures,
                                           seed=seed)
            base = np.log(np.maximum(sig, 1e-50)).transpose(1, 0, 2)
            per_gas[ig] = base[..., None] + spread[None, None, None, :]
        per_gas = jnp.asarray(per_gas)
    return CKTable(arrays, molecules, abunds, gauss_pts, temps, pressures,
                   per_gas=per_gas, per_gas_molecules=molecules,
                   wno=wno, delta_wno=delta_wno, gauss_wts=gauss_wts)


# ---------------------------------------------------------------------------
# on-device interpolation
# ---------------------------------------------------------------------------

def _neighbours(t_inv_grid, p_log_grid, nc_p, tlayer, player_bar):
    """Shared (1/T, log10 P) neighbour search (optics.py:1098-1152)."""
    t_inv = 1.0 / tlayer
    p_log = jnp.log10(player_bar)
    ntemp = t_inv_grid.shape[0]
    npress = p_log_grid.shape[0]

    gt = (t_inv_grid[None, :] > t_inv[:, None]).astype(jnp.int32)
    any_gt = gt.sum(axis=1) > 0
    t_low = jnp.where(any_gt, ntemp - 1 - jnp.argmax(gt[:, ::-1], axis=1), 0)
    t_low = jnp.minimum(t_low, ntemp - 2)
    t_hi = t_low + 1

    le = (p_log_grid[None, :] <= p_log[:, None]).astype(jnp.int32)
    any_le = le.sum(axis=1) > 0
    p_low = jnp.where(any_le, npress - 1 - jnp.argmax(le[:, ::-1], axis=1), 0)
    p_low = jnp.maximum(jnp.minimum(p_low, nc_p[t_hi] - 3), 0)
    p_hi = p_low + 1

    t_w = (t_inv - t_inv_grid[t_low]) / (t_inv_grid[t_hi]
                                         - t_inv_grid[t_low])
    p_w = (p_log - p_log_grid[p_low]) / (p_log_grid[p_hi]
                                         - p_log_grid[p_low])
    return t_low, t_hi, p_low, p_hi, t_w, p_w


@jax.jit
def interp_premix(ck: CKArrays, tlayer, player_bar):
    """Premixed molecular opacity [nlayer, nwno, ngauss] x Avogadro.

    Bilinear in (1/T, log10 P) on ln kappa (optics.py:1151-1161).
    """
    t_low, t_hi, p_low, p_hi, t_w, p_w = _neighbours(
        ck.t_inv_grid, ck.p_log_grid, ck.nc_p, tlayer, player_bar)
    tw = t_w[:, None, None]
    pw = p_w[:, None, None]
    k = ck.ln_kappa
    ln_k = ((1 - tw) * (1 - pw) * k[p_low, t_low]
            + tw * (1 - pw) * k[p_low, t_hi]
            + tw * pw * k[p_hi, t_hi]
            + (1 - tw) * pw * k[p_hi, t_low])
    return jnp.exp(ln_k) * AVOGADRO


@jax.jit
def ck_continuum(ck: CKArrays, tlayer):
    """CIA at layer temperatures, log-interp in 1/T (optics.py:1474-1497).

    Returns [ncont, nlayer, nwno].
    """
    temps = ck.cia_temps
    n = temps.shape[0]
    ihi = jnp.clip(jnp.searchsorted(temps, tlayer), 1, n - 1)
    ilo = ihi - 1
    t_lo = temps[ilo]
    t_hi = temps[ihi]
    t_w = ((1.0 / tlayer - 1.0 / t_lo) / (1.0 / t_hi - 1.0 / t_lo))
    lo = jnp.log(ck.cont_opa[:, ilo, :])
    hi = jnp.log(ck.cont_opa[:, ihi, :])
    return jnp.exp((1 - t_w)[None, :, None] * lo
                   + t_w[None, :, None] * hi)


def ck_taugas(ck_table, atm):
    """TAUGAS [ngauss, nlayer, nwno] for the spectrum path.

    Premixed kappa needs no mixing-ratio weighting (optics.py:257-262);
    with per-gas tables attached the molecular k-coefficients are instead
    resort-rebin mixed on the fly from the atmosphere's own abundances
    (gasesfly mode, optics.py:1164-1198).  Continuum follows the CK CIA
    log-interp either way.
    """
    from . import assemble
    from ..constants import PCONV

    if ck_table.per_gas is not None:
        from . import resortrebin as rr
        mixes = jnp.stack([
            jnp.asarray(atm.mixing_ratio_layer(m))
            if m in atm.molecules else jnp.zeros(atm.nlayer)
            for m in ck_table.per_gas_molecules])
        kappa = rr.resortrebin_kappa(
            ck_table.per_gas, ck_table.arrays.t_inv_grid,
            ck_table.arrays.p_log_grid, ck_table.arrays.nc_p,
            jnp.asarray(ck_table.gauss_pts),
            jnp.asarray(ck_table.gauss_wts), mixes,
            jnp.asarray(atm.t_layer), jnp.asarray(atm.p_layer / PCONV))
    else:
        kappa = interp_premix(ck_table.arrays, jnp.asarray(atm.t_layer),
                              jnp.asarray(atm.p_layer / PCONV))
    taugas = (kappa * (atm.colden / atm.mmw_layer)[:, None, None]
              ).transpose(2, 0, 1)

    pairs = atm.continuum_pairs(ck_table.continuum_molecules)
    specs = assemble.classify_continuum(pairs)
    if specs:
        nlayer = atm.nlayer
        cont = ck_continuum(ck_table.arrays, jnp.asarray(atm.t_layer))
        cont_kappa = {
            s.name: cont[list(ck_table.continuum_molecules).index(s.name)]
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
    return taugas
