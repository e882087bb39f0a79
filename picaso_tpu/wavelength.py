"""Wavelength-grid utilities (cloud input grids, regridding, binning).

Mirrors ``/root/reference/picaso/wavelength.py`` plus the ``mean_regrid``
spectral binning helper from ``justplotit.py:31``.
"""

from __future__ import annotations

import os

import numpy as np
import pandas as pd

from .refdata import refdata_path

__all__ = ['get_cld_input_grid', 'regrid', 'mean_regrid', 'create_grid',
           'conv_non_uniform_R']


def get_cld_input_grid(filename_or_grid='wave_EGP.dat', grid661=False):
    """196-point EGP cloud wavenumber grid (or 661 climate grid), ascending."""
    if grid661:
        grid = np.loadtxt(refdata_path('climate_INPUTS', 'wvno_661'),
                          usecols=[0])
        return grid
    if isinstance(filename_or_grid, np.ndarray):
        return np.sort(filename_or_grid)
    if filename_or_grid == 'wave_EGP.dat':
        path = refdata_path('opacities', 'wave_EGP.dat')
    else:
        path = filename_or_grid
    grid = pd.read_csv(path, sep=r'\s+')
    return grid.sort_values('wavenumber')['wavenumber'].values


def regrid(matrix, old_wno, new_wno):
    """Row-wise linear re-interpolation onto a new wavenumber grid."""
    matrix = np.asarray(matrix, dtype=np.float64)
    new = np.zeros((matrix.shape[0], len(new_wno)))
    for i in range(matrix.shape[0]):
        new[i, :] = np.interp(np.asarray(new_wno, dtype=np.float64),
                              np.asarray(old_wno, dtype=np.float64),
                              matrix[i, :])
    return new


def create_grid(min_wavelength, max_wavelength, constant_R):
    """Constant-R wavenumber grid, exact port of the reference construction
    (opacity_factory.py:712-739): geometric wavelength spacing
    (2R+1)/(2R-1) from min_wavelength, returned as ascending wavenumbers."""
    spacing = (2.0 * constant_R + 1.0) / (2.0 * constant_R - 1.0)
    npts = np.log(max_wavelength / min_wavelength) / np.log(spacing)
    wsize = int(np.ceil(npts)) + 1
    # cumprod = the reference's sequential newwl[j] = newwl[j-1]*spacing,
    # bit-identical (spacing**arange drifts by ~1e-12 over 1e6 points)
    newwl = np.concatenate(
        [[min_wavelength],
         min_wavelength * np.cumprod(np.full(wsize - 1, spacing))])
    return 1e4 / newwl[::-1]


def create_grid_minR(min_wavelength, max_wavelength, minimum_R):
    """Uniform-dwno wavenumber grid with the step set by ``minimum_R`` at
    ``min_wavelength`` (opacity_factory.py:692-710).  NB: matching the
    reference exactly, the spectral resolving power wno/dwno equals
    ``minimum_R`` at the short-wavelength end and FALLS toward longer
    wavelengths (by min_wavelength/max_wavelength at the red end) —
    despite the reference docstring's "all_Rs>R" claim.  Returns
    (wavenumber grid ascending, dwno)."""
    dwno = 1e4 / (min_wavelength ** 2) * (min_wavelength / minimum_R)
    grid = np.arange(1e4 / max_wavelength, 1e4 / min_wavelength, dwno)
    return grid, dwno


def conv_non_uniform_R(model_flux, model_wl, R, obs_wl):
    """Convolve a model spectrum with a wavelength-dependent resolving
    power onto an observed wavelength grid (driver.py:338-381).

    The reference loops a Gaussian kernel per observed point; here the
    whole operation is one [nobs, nmodel] kernel matrix applied as a
    matvec (works on numpy or jax arrays and can sit
    inside a jitted likelihood).

    Parameters: model_flux/model_wl [nmodel]; R [nobs] resolving power at
    each observed wavelength; obs_wl [nobs].  Returns [nobs].
    """
    xp = np if isinstance(model_flux, np.ndarray) else __import__(
        'jax.numpy', fromlist=['numpy'])
    model_wl = xp.asarray(model_wl)
    obs_wl = xp.asarray(obs_wl)
    R = xp.asarray(R)
    sigma = (obs_wl / R) / 2.355                       # FWHM -> sigma
    arg = ((model_wl[None, :] - obs_wl[:, None])
           / sigma[:, None]) ** 2
    kern = xp.exp(-0.5 * arg)
    kern = kern / xp.sum(kern, axis=1, keepdims=True)
    return kern @ xp.asarray(model_flux)


def mean_regrid(x, y, newx=None, R=None):
    """Bin a spectrum to a new grid; exact port of justplotit.py:31-63.

    Either supply target centers ``newx`` (bin edges are midpoints between
    centers, extended by half a step at both ends) or a resolving power
    ``R`` (the constant-R grid is used directly as the bin edges).  Returns
    the arithmetic bin centers and per-bin means (NaN for empty bins).
    """
    from scipy.stats import binned_statistic

    x = np.asarray(x)
    y = np.asarray(y)
    if newx is None and R is not None:
        newx = create_grid(1e4 / np.max(x), 1e4 / np.min(x), R)
    elif newx is not None and R is None:
        newx = np.asarray(newx)
        d = np.diff(newx)
        newx = np.concatenate([[newx[0] - d[0] / 2.0],
                               newx[:-1] + d / 2.0,
                               [newx[-1] + d[-1] / 2.0]])
    else:
        raise ValueError('Please either enter a newx or a R')
    y, edges, _ = binned_statistic(x, y, bins=newx)
    newx = (edges[:-1] + edges[1:]) / 2.0
    return newx, y
