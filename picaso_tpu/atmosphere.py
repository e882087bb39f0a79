"""Atmosphere state: profile parsing and derived hydrostatic structure.

JAX equivalent of the reference ``ATMSETUP`` class
(``/root/reference/picaso/atmsetup.py``).  Instead of a mutable class that is
deep-copied per facet, the atmosphere is a frozen :class:`Atmosphere` bundle
of arrays built once on the host; every derived quantity (mmw, altitude,
column density, cloud regrid) is a pure function.  Facets of a 3D run become
leading batch axes instead of ``disect`` copies.

Semantics preserved from the reference (file:line):
- layer P = sqrt(P_i * P_{i+1}), layer T = mean         (atmsetup.py:223-224)
- hydrostatic altitude with reference-pressure snapping (atmsetup.py:384-461)
- column density (P_{i+1}-P_i)/g_layer                  (atmsetup.py:549-555)
- cloud 196-grid regrid via row-wise linear interp      (atmsetup.py:558-657,
  wavelength.py:44-69)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from . import molmass
from .constants import AMU, G_GRAV, K_B, PCONV

__all__ = ['Atmosphere', 'build_atmosphere', 'regrid_rows']


@dataclasses.dataclass
class Atmosphere:
    """Frozen 1D atmosphere state (all arrays numpy, CGS)."""
    # levels [nlevel]
    pressure: np.ndarray          # dyne/cm^2
    temperature: np.ndarray       # K
    mmw_level: np.ndarray         # amu
    z: np.ndarray                 # cm
    dz: np.ndarray                # cm
    scale_height: np.ndarray      # cm
    electrons_level: Optional[np.ndarray]
    # layers [nlayer]
    p_layer: np.ndarray
    t_layer: np.ndarray
    mmw_layer: np.ndarray
    gravity_layer: np.ndarray
    colden: np.ndarray            # g/cm^2
    dtdp: np.ndarray
    electrons_layer: Optional[np.ndarray]
    # composition
    molecules: List[str]
    weights: Dict[str, float]
    mixingratios_level: np.ndarray   # [nlevel, nmol]
    mixingratios_layer: np.ndarray   # [nlayer, nmol]
    # clouds [nlayer, nwno] on the working wavenumber grid
    cld_opd: Optional[np.ndarray] = None
    cld_g0: Optional[np.ndarray] = None
    cld_w0: Optional[np.ndarray] = None
    # planet
    gravity: float = np.nan       # cm/s^2 (surface/reference)
    radius: float = np.nan        # cm
    mass: float = np.nan          # g
    warnings: tuple = ()

    @property
    def nlevel(self):
        return len(self.pressure)

    @property
    def nlayer(self):
        return self.nlevel - 1

    def mixing_ratio_layer(self, molecule):
        return self.mixingratios_layer[:, self.molecules.index(molecule)]

    def mixing_ratio_level(self, molecule):
        return self.mixingratios_level[:, self.molecules.index(molecule)]

    def continuum_pairs(self, available_continuum):
        """CIA pairs + special continua present (atmsetup.py:248-277)."""
        simple = [_simple_name(m) for m in self.molecules]
        pairs = []
        for m1 in simple:
            for m2 in simple:
                if m1 + m2 in available_continuum:
                    pairs.append((m1, m2))
        if 'H-' in simple and 'H-bf' in available_continuum:
            pairs.append(('H-', 'bf'))
        if ('H' in simple and self.electrons_level is not None
                and 'H-ff' in available_continuum):
            pairs.append(('H-', 'ff'))
        if ('H2' in simple and self.electrons_level is not None
                and 'H2-' in available_continuum):
            pairs.append(('H2-', ''))
        return pairs

    def rayleigh_species(self, available_ray_mol):
        simple = [_simple_name(m) for m in self.molecules]
        return [m for m in simple if m in available_ray_mol]


def _simple_name(molecule: str) -> str:
    """Strip isotope markers: '13C_16O2' -> 'CO2' (atmsetup convert_to_simple)."""
    if '_' not in molecule:
        return molecule
    import re
    out = []
    for part in molecule.split('_'):
        m = re.match(r'^\d*([A-Za-z+\-\d]*)$', part)
        out.append(re.sub(r'^\d+', '', part))
    return ''.join(out)


def _hydrostatic(plevel, tlevel, mmw_level, gravity, radius, mass,
                 p_reference_bar):
    """z, dz, layer gravity, scale height (port of atmsetup.py:384-461)."""
    nlevel = len(plevel)
    constant_gravity = not np.isfinite(radius)
    p_reference = p_reference_bar * PCONV
    mmw = mmw_level * AMU

    if p_reference >= np.max(plevel):
        p_reference = np.max(plevel)
    else:
        # snap reference pressure onto the grid (atmsetup.py:407-414)
        p_reference = plevel[plevel >= p_reference][0]

    z = np.zeros(nlevel) + (radius if np.isfinite(radius) else 0.0)
    dz = np.zeros(nlevel)
    grav = np.zeros(nlevel)

    indx = np.unique(np.where(plevel > p_reference)[0])
    if len(indx) > 0:
        for i in indx - 1:
            grav[i] = gravity if constant_gravity else G_GRAV * mass / z[i] ** 2
            scale_h = K_B * tlevel[i] / (mmw[i] * grav[i])
            dz[i] = scale_h * np.log(plevel[i + 1] / plevel[i])
            z[i + 1] = z[i] - dz[i]

    for i in np.unique(np.where(plevel <= p_reference)[0])[::-1][:-1]:
        grav[i] = gravity if constant_gravity else G_GRAV * mass / z[i] ** 2
        scale_h = K_B * tlevel[i] / (mmw[i] * grav[i])
        dz[i] = scale_h * np.log(plevel[i] / plevel[i - 1])
        z[i - 1] = z[i] + dz[i]

    dz[0] = dz[1]
    dz[-1] = dz[-2]

    gravity_layer = 0.5 * (grav[:-1] + grav[1:])
    if constant_gravity:
        grav[0] = grav[-1] = gravity
    else:
        grav[0] = G_GRAV * mass / z[0] ** 2
        grav[-1] = G_GRAV * mass / z[-1] ** 2
    scale_height = K_B * tlevel / (mmw * grav)
    return z, dz, gravity_layer, scale_height


def regrid_rows(matrix, old_wno, new_wno):
    """Row-wise np.interp regrid (port of wavelength.py:44-69)."""
    matrix = np.asarray(matrix, dtype=np.float64)
    if old_wno is None or np.array_equal(old_wno, new_wno):
        return matrix
    out = np.zeros((matrix.shape[0], len(new_wno)))
    for i in range(matrix.shape[0]):
        out[i] = np.interp(new_wno, old_wno, matrix[i])
    return out


def build_atmosphere(profile, gravity=np.nan, radius=np.nan, mass=np.nan,
                     p_reference=1.0, wno=None, cld_profile=None,
                     cld_wno=None) -> Atmosphere:
    """Construct the full Atmosphere from a profile table.

    Parameters
    ----------
    profile : mapping or pandas.DataFrame
        Columns 'pressure' (bar), 'temperature' (K) plus one mixing-ratio
        column per molecule ('e-' handled as electrons).
    gravity, radius, mass : float
        CGS planet parameters.  If radius is NaN, constant gravity is used.
    p_reference : float
        Reference pressure in bar for the altitude integration.
    wno : array, optional
        Working wavenumber grid; needed to place clouds on the grid.
    cld_profile : mapping, optional
        Flat columns opd/g0/w0 of length nlayer*len(cld_wno) (reference .cld
        layout, atmsetup.py:558-623).
    """
    cols = list(profile.keys())
    get = (lambda k: np.asarray(profile[k], dtype=np.float64))

    tlevel = get('temperature')
    p_bar = get('pressure')
    plevel = p_bar * PCONV

    molecules, weights, mix_cols = [], {}, []
    electrons_level = None
    warnings = []
    for c in cols:
        if c in ('pressure', 'temperature'):
            continue
        if c == 'e-':
            electrons_level = get(c)
            continue
        if 'guess' in c or 'kz' in c.lower():
            continue
        try:
            w = molmass.molecular_weight(c)
        except KeyError:
            warnings.append(f'Ignoring {c} in input file, not recognized '
                            'molecule')
            continue
        molecules.append(c)
        weights[c] = w
        mix_cols.append(get(c))

    mix_level = (np.stack(mix_cols, axis=1) if mix_cols
                 else np.zeros((len(plevel), 0)))
    mix_layer = 0.5 * (mix_level[1:] + mix_level[:-1])
    electrons_layer = (None if electrons_level is None
                       else 0.5 * (electrons_level[1:] + electrons_level[:-1]))

    t_layer = 0.5 * (tlevel[1:] + tlevel[:-1])
    p_layer = np.sqrt(plevel[1:] * plevel[:-1])

    wvec = np.array([weights[m] for m in molecules])
    mmw_level = mix_level @ wvec if len(molecules) else np.zeros(len(plevel))
    mmw_layer = 0.5 * (mmw_level[:-1] + mmw_level[1:])

    z, dz, gravity_layer, scale_height = _hydrostatic(
        plevel, tlevel, mmw_level, gravity, radius, mass, p_reference)

    colden = (plevel[1:] - plevel[:-1]) / gravity_layer
    dtdp = np.diff(np.log(tlevel)) / np.diff(np.log(plevel))

    nlayer = len(p_layer)
    if cld_profile is not None:
        nw_in = len(cld_wno) if cld_wno is not None else (
            len(np.asarray(cld_profile['opd'])) // nlayer)
        opd = np.reshape(np.asarray(cld_profile['opd'], dtype=np.float64),
                         (nlayer, nw_in))
        g0 = np.reshape(np.asarray(cld_profile['g0'], dtype=np.float64),
                        (nlayer, nw_in))
        w0 = np.reshape(np.asarray(cld_profile['w0'], dtype=np.float64),
                        (nlayer, nw_in))
        if wno is not None and cld_wno is not None:
            opd = regrid_rows(opd, cld_wno, wno)
            g0 = regrid_rows(g0, cld_wno, wno)
            w0 = regrid_rows(w0, cld_wno, wno)
    elif wno is not None:
        opd = np.zeros((nlayer, len(wno)))
        g0 = np.zeros((nlayer, len(wno)))
        w0 = np.zeros((nlayer, len(wno)))
    else:
        opd = g0 = w0 = None

    return Atmosphere(
        pressure=plevel, temperature=tlevel, mmw_level=mmw_level, z=z, dz=dz,
        scale_height=scale_height, electrons_level=electrons_level,
        p_layer=p_layer, t_layer=t_layer, mmw_layer=mmw_layer,
        gravity_layer=gravity_layer, colden=colden, dtdp=dtdp,
        electrons_layer=electrons_layer, molecules=molecules, weights=weights,
        mixingratios_level=mix_level, mixingratios_layer=mix_layer,
        cld_opd=opd, cld_g0=g0, cld_w0=w0,
        gravity=gravity, radius=radius, mass=mass, warnings=tuple(warnings))
