"""Per-source optical depth assembly (molecular, continuum, Rayleigh, cloud).

Jax port of the TAUGAS/TAURAY/TAUCLD construction in
``/root/reference/picaso/optics.py:132-315``.  The molecule loop of the
reference becomes index-gathered batched array math: the host decides *which*
species participate (static metadata), the device does all the arithmetic.

Continuum unit conventions preserved exactly:
* standard CIA pairs use the amagat^2 integral COEF1 (optics.py:155-164)
  with R_gas in SI, pressures in bar, gravity in m/s^2 — "THIS IS DANGEROUS"
  comments and all;
* H-bf, H-ff, H2- special cases follow optics.py:175-219.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import AMU, K_B, R_GAS

__all__ = ['ContinuumSpec', 'continuum_tau', 'molecular_tau', 'rayleigh_tau']


class ContinuumSpec(NamedTuple):
    """Static description of one continuum source for the assembly kernel."""
    name: str          # e.g. 'H2H2', 'H-bf', 'H-ff', 'H2-'
    kind: str          # 'cia' | 'H-bf' | 'H-ff' | 'H2-'
    mol1: str          # first collider (mixing-ratio column)
    mol2: str          # second collider ('' for specials)


def classify_continuum(pairs):
    """[(m1, m2)] from Atmosphere.continuum_pairs -> list[ContinuumSpec]."""
    specs = []
    for m1, m2 in pairs:
        if m1 == 'H-' and m2 == 'bf':
            specs.append(ContinuumSpec('H-bf', 'H-bf', 'H-', ''))
        elif m1 == 'H-' and m2 == 'ff':
            specs.append(ContinuumSpec('H-ff', 'H-ff', 'H', ''))
        elif m1 == 'H2-':
            specs.append(ContinuumSpec('H2-', 'H2-', 'H2', ''))
        else:
            specs.append(ContinuumSpec(m1 + m2, 'cia', m1, m2))
    return specs


def amagat_coef1(tlevel, plevel_bar, tlayer, player_bar, gravity_cgs,
                 mmw_layer):
    """COEF1 amagat^2 path integral per layer (optics.py:144-164)."""
    gravity_si = gravity_cgs / 100.0
    ACOEF = (tlayer / (tlevel[:-1] * tlevel[1:])) * (
        tlevel[1:] * plevel_bar[1:] - tlevel[:-1] * plevel_bar[:-1]) / (
        plevel_bar[1:] - plevel_bar[:-1])
    BCOEF = (tlayer / (tlevel[:-1] * tlevel[1:])) * (
        tlevel[:-1] - tlevel[1:]) / (plevel_bar[1:] - plevel_bar[:-1])
    COEF1 = R_GAS * 273.15 ** 2 * 0.5e5 * (
        ACOEF * (plevel_bar[1:] ** 2 - plevel_bar[:-1] ** 2)
        + BCOEF * (2.0 / 3.0) * (plevel_bar[1:] ** 3 - plevel_bar[:-1] ** 3)
    ) / (1.01325 ** 2 * gravity_si * tlayer * mmw_layer)
    return COEF1


def continuum_tau(specs, cont_kappa, mix, electrons_layer, coef1,
                  player_cgs, tlayer, colden, mmw_layer):
    """Summed continuum optical depth [nlayer, nwno].

    Parameters
    ----------
    specs : list[ContinuumSpec] (static)
    cont_kappa : dict name -> [nlayer, nwno] continuum opacity at the layer
        temperatures (already nearest-neighbour selected)
    mix : dict molecule -> [nlayer] mixing ratio
    """
    nlayer = len(tlayer)
    tau = 0.0
    for spec in specs:
        k = cont_kappa[spec.name]
        if spec.kind == 'cia':
            add = k * (coef1 * mix[spec.mol1] * mix[spec.mol2])[:, None]
        elif spec.kind == 'H-bf':
            add = k * (mix['H-'] * colden / (mmw_layer * AMU))[:, None]
        elif spec.kind == 'H-ff':
            add = k * (player_cgs * mix['H'] * electrons_layer * colden
                       / (tlayer * mmw_layer * AMU * K_B))[:, None]
        elif spec.kind == 'H2-':
            add = k * (player_cgs * mix['H2'] * electrons_layer * colden
                       / (mmw_layer * AMU))[:, None]
        else:
            raise ValueError(spec.kind)
        tau = tau + add
    if isinstance(tau, float):
        return None
    return tau


def molecular_tau(kappa, mix_cols, colden, mmw_layer, fac=None):
    """Summed molecular optical depth [nlayer, nwno].

    kappa: [nmol, nlayer, nwno] cross sections (already Avogadro-scaled,
    optics.py:243-255); mix_cols: [nmol, nlayer]; fac: optional [nmol]
    exclude_mol multipliers.
    """
    w = mix_cols * colden[None, :] / mmw_layer[None, :]
    if fac is not None:
        w = w * fac[:, None]
    return jnp.einsum('mlw,ml->lw', kappa, w.astype(kappa.dtype),
                      precision=jax.lax.Precision.HIGHEST)


def rayleigh_tau(sigma, mix_cols, colden, mmw_layer):
    """Rayleigh optical depth [nlayer, nwno] (optics.py:264-271).

    sigma: [nmol_ray, nwno] cross sections; mix_cols: [nmol_ray, nlayer].
    """
    w = mix_cols * colden[None, :] / mmw_layer[None, :]
    return jnp.einsum('mw,ml->lw', sigma, w.astype(sigma.dtype),
                      precision=jax.lax.Precision.HIGHEST)
