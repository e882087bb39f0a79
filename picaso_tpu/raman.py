"""Raman scattering corrections to the Rayleigh single-scattering albedo.

Port of ``/root/reference/picaso/optics.py:435-652``: the Oklopcic+2018
H2 Raman cross sections with shifted stellar spectra (option 0), the legacy
Pollack+1986 factor table (option 1), and 'none' (0.99999).  The Oklopcic
computation is pure array math (outer products over the ~50 table rows) and
runs jitted on device; the table load and stellar binning happen once at
connection time.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd

__all__ = ['load_raman_db', 'bin_star', 'compute_stellar_shifts',
           'raman_factor_oklopcic', 'raman_factor_pollack']

_NUM_J = 10  # hard-coded number of H2 rotational levels (optics.py:473)

# H2 rotational constants for the partition function (optics.py:541-545)
_KB = 1.38064852e-16
_B_ROT = 60.853
_C = 29979245800.0
_H = 6.62607004e-27


def load_raman_db(filename):
    """Oklopcic cross-section table (raman.txt, 16-row header).

    The 'c' cross sections (~1e-45) only ever enter scale-invariant
    ratios (raman_factor_oklopcic), but raw they underflow float32 on
    device — normalize to max=1 at load time.
    """
    df = pd.read_csv(filename, sep=r'\s+', skiprows=16, header=None,
                     names=['ji', 'jf', 'vf', 'c', 'deltanu'])
    df['c'] = df['c'] / df['c'].abs().max()
    return df


def bin_star(wno_new, wno_old, Fp):
    """Tophat-average a hires stellar spectrum onto the model grid.

    Port of optics.py:496-521 (same edge handling).
    """
    wno_new = np.asarray(wno_new)
    szmod = wno_new.shape[0]
    delta = np.zeros(szmod)
    Fint = np.zeros(szmod)
    delta[0:-1] = wno_new[1:] - wno_new[:-1]
    delta[szmod - 1] = delta[szmod - 2]
    for i in range(1, szmod):
        loc = np.where((wno_old >= wno_new[i] - 0.5 * delta[i - 1])
                       & (wno_old < wno_new[i] + 0.5 * delta[i]))
        Fint[i] = np.mean(Fp[loc])
    loc = np.where((wno_old > wno_new[0] - 0.5 * delta[0])
                   & (wno_old < wno_new[0] + 0.5 * delta[0]))
    Fint[0] = np.mean(Fp[loc])
    return Fint


def compute_stellar_shifts(model_wno, raman_db, wno_star, flux_star):
    """Shifted/unshifted stellar flux ratios (optics.py:2370-2402).

    Returns [nwno, n_table_rows]; also the unshifted binned stellar spec.
    """
    deltanu = raman_db['deltanu'].values
    all_shifted = np.zeros((len(model_wno), len(deltanu)))
    unshifted_spec = bin_star(model_wno, wno_star, flux_star)
    unshifted = None
    for i in range(len(deltanu)):
        shifted_flux = bin_star(model_wno + deltanu[i], wno_star, flux_star)
        if i == 0:
            unshifted = shifted_flux
        all_shifted[:, i] = shifted_flux / unshifted
    # shifted wavenumbers outside the stellar spectrum's coverage (empty
    # tophat bins -> NaN means) get the neutral ratio — those are far-IR
    # model wavelengths where the Raman correction is irrelevant
    all_shifted = np.where(np.isfinite(all_shifted), all_shifted, 1.0)
    return all_shifted, unshifted_spec


def _partition_function(j, T):
    b_energy = _B_ROT * _H * _C * j * (j + 1) / _KB
    g = (2.0 * j + 1.0) if j % 2 == 0 else 3.0 * (2.0 * j + 1.0)
    return g * jnp.exp(-0.5 * b_energy * j * (j + 1) / T)


def _j_fraction(T):
    """[NUM_J, nlayer] Boltzmann fractions (optics.py:569-581)."""
    Z = sum(_partition_function(j, T) for j in range(20))
    return jnp.stack([_partition_function(j, T) / Z for j in range(_NUM_J)])


def raman_factor_oklopcic(wno, stellar_shifts, tlayer, cross_sections,
                          j_initial, deltanu):
    """Modified rayleigh single-scattering factor [nlayer, nwno].

    Port of compute_raman (optics.py:435-494): sums per-table-row cross
    sections Q = C / wno^3 / (wno+dnu), weighted by the layer J-level
    population, with the dnu=0 rows counted as pure Rayleigh.
    """
    j_at_temp = _j_fraction(tlayer)            # [10, nlayer]
    shifted_wno = wno[None, :] + deltanu[:, None]           # [nrow, nwno]
    # cross sections are ~1e-45 and Q ~ 1e-53 — far below the f32 minimum
    # normal (1e-38), so un-normalized Q underflows to 0 and the factor
    # becomes 0/0 in f32.  The returned quantity is a ratio of Q-sums, so
    # any fixed rescale cancels exactly.
    cross_sections = cross_sections / jnp.max(jnp.abs(cross_sections))
    Q = cross_sections[:, None] / wno[None, :] ** 3.0 / shifted_wno
    is_ray = (deltanu == 0)[:, None]
    pop = j_at_temp[j_initial]                  # [nrow, nlayer]

    hi = jax.lax.Precision.HIGHEST
    ray = jnp.einsum('rl,rw->lw', pop * is_ray, Q, precision=hi)
    w_shift = jnp.einsum('rl,rw->lw', pop * (~is_ray),
                         Q * stellar_shifts.T, precision=hi)
    wo_shift = jnp.einsum('rl,rw->lw', pop * (~is_ray), Q, precision=hi)
    # far-IR wavelengths with wno < |deltanu| have unphysical negative
    # shifted wavenumbers whose Q terms can cancel the denominator to
    # ~0 (0/0 at f32); Raman corrections are meaningless there, so fall
    # back to the neutral factor (the 0.99999 cap applies downstream)
    denom = ray + wo_shift
    ok = jnp.abs(denom) > 1e-30
    return jnp.where(ok, (ray + w_shift) / jnp.where(ok, denom, 1.0), 1.0)


def raman_factor_pollack(nlayer, wave, refdata_dir=None):
    """Legacy Pollack factor, layer-independent (optics.py:584-652)."""
    refdata_dir = refdata_dir or os.environ.get('picaso_refdata')
    dat = pd.read_csv(os.path.join(refdata_dir, 'opacities',
                                   'raman_fortran.txt'),
                      sep=r'\s+', header=None, names=['w', 'f'])
    interp_raman = np.interp(wave, dat['w'].values, dat['f'].values)
    return np.broadcast_to(interp_raman, (nlayer, len(wave))).copy()
