"""The XLA opacity gather (db.interp_molecular + assemble.molecular_tau)
against a float64 numpy re-implementation of the reference's bilinear
(1/T, log10 P) interpolation (optics.py:2048-2123, :2290-2294), on the
regular and the ragged 1060-point (T, P) grids."""

import numpy as np
import jax.numpy as jnp
import pytest

from picaso_tpu.opacities import assemble
from picaso_tpu.opacities.db import AVOGADRO, interp_molecular
from picaso_tpu.opacities.factory import (synthetic_opacity_grid,
                                          synthetic_opacity_grid_ragged)

MOLECULES_16 = ('H2O', 'CH4', 'CO', 'NH3', 'CO2', 'H2S', 'TiO', 'VO', 'Na',
                'K', 'FeH', 'C2H2', 'HCN', 'PH3', 'SO2', 'CrH')


def _numpy_tau(grid, tlayer, player_bar, mix, colden, mmw):
    """Loop form of the reference neighbour search and interpolation."""
    t_inv_grid = np.asarray(grid.pt.t_inv_grid, np.float64)
    p_grid = np.asarray(grid.pt.p_log_grid, np.float64)
    nc_p = np.asarray(grid.pt.nc_p)
    t_offset = np.asarray(grid.pt.t_offset)
    logk_tab = np.asarray(grid.log_kappa, np.float64)
    nmol, nlayer = len(grid.molecules), len(tlayer)
    tau = np.zeros((nlayer, logk_tab.shape[-1]))
    for l in range(nlayer):
        t_inv = 1.0 / tlayer[l]
        p_log = np.log10(player_bar[l])
        above = np.nonzero(t_inv_grid > t_inv)[0]
        t_lo = min(above[-1] if len(above) else 0, len(t_inv_grid) - 2)
        t_hi = t_lo + 1
        below = np.nonzero(p_grid <= p_log)[0]
        p_lo = max(min(below[-1] if len(below) else 0, nc_p[t_hi] - 3), 0)
        p_hi = p_lo + 1
        tw = (t_inv - t_inv_grid[t_lo]) / (t_inv_grid[t_hi] - t_inv_grid[t_lo])
        pw = (p_log - p_grid[p_lo]) / (p_grid[p_hi] - p_grid[p_lo])
        corners = [(t_offset[t_lo] + p_lo, (1 - tw) * (1 - pw)),
                   (t_offset[t_hi] + p_lo, tw * (1 - pw)),
                   (t_offset[t_hi] + p_hi, tw * pw),
                   (t_offset[t_lo] + p_hi, (1 - tw) * pw)]
        for m in range(nmol):
            logk = sum(w * logk_tab[m, i] for i, w in corners)
            tau[l] += (10.0 ** logk * AVOGADRO
                       * mix[m, l] * colden[l] / mmw[l])
    return tau


@pytest.mark.parametrize('layout', ['regular', 'ragged'])
@pytest.mark.parametrize('dtype', [np.float32, np.float64])
@pytest.mark.parametrize('nmol', [1, 16])
def test_gather_matches_numpy(layout, dtype, nmol):
    wno = np.linspace(1000.0, 15000.0, 96)
    molecules = MOLECULES_16[:nmol]
    if layout == 'ragged':
        grid = synthetic_opacity_grid_ragged(wno, molecules, dtype=dtype)
    else:
        grid = synthetic_opacity_grid(wno, molecules=molecules, ntemp=6,
                                      npress=5, dtype=dtype)
    rng = np.random.default_rng(nmol)
    nlayer = 20
    # spans the grid edges: clamped temperatures and pressures included
    tlayer = rng.uniform(60.0, 4000.0, nlayer)
    player = np.logspace(-7, 3, nlayer)
    mix = rng.uniform(1e-8, 1e-3, (nmol, nlayer))
    colden = rng.uniform(1.0, 100.0, nlayer)
    mmw = rng.uniform(2.2, 2.4, nlayer)

    kappa = interp_molecular(grid, jnp.asarray(tlayer, dtype),
                             jnp.asarray(player, dtype))
    got = np.asarray(assemble.molecular_tau(
        kappa, jnp.asarray(mix, dtype), jnp.asarray(colden, dtype),
        jnp.asarray(mmw, dtype)))
    want = _numpy_tau(grid, np.asarray(tlayer, dtype).astype(np.float64),
                      np.asarray(player, dtype).astype(np.float64), mix,
                      colden, mmw)
    assert got.dtype == dtype
    # f32: log10 kappa ~ -30 carries ~2e-6 absolute error in the exponent
    rtol = 1e-4 if dtype == np.float32 else 1e-10
    np.testing.assert_allclose(got, want, rtol=rtol)
