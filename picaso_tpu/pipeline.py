"""Fused, fully-jittable spectrum pipeline.

One XLA program computes opacity interpolation -> optics fusion -> RT ->
disk integration for all requested calculations.  This is the hot path the
benchmarks and the multi-chip sharding run through; the friendly ``inputs``
API (:mod:`picaso_tpu.justdoit`) builds the same pieces stepwise for
debuggability.

Everything data-dependent is a traced array in :class:`SceneTensors`;
everything that changes program structure (molecule index maps, continuum
pair kinds, phase-function options) is static in :class:`SpectrumConfig`.
That split is the jit analog of the reference's string->int enum compilation
for numba (justdoit.py:4635-4738) — and it means a retrieval can update
temperatures/abundances and re-run with zero recompilation and zero host
work.
"""

from __future__ import annotations

import dataclasses
import os
from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .constants import AMU, K_B, PCONV
from .opacities import assemble
from .opacities.db import OpacityGrid, interp_molecular, nearest_continuum
from .optics import combine_optics
from .rt import toon
from .rt.transit import transit_depth
from . import disco as disco_mod

__all__ = ['SceneTensors', 'SpectrumConfig', 'forward', 'forward_batch',
           'forward_reference', 'gather_taugas',
           'stack_scenes', 'scene_from_case']


class SceneTensors(NamedTuple):
    """All traced per-scene arrays (CGS)."""
    tlevel: jnp.ndarray          # [nlevel]
    plevel: jnp.ndarray          # [nlevel] dyne/cm^2
    tlayer: jnp.ndarray          # [nlayer]
    player: jnp.ndarray          # [nlayer] dyne/cm^2
    colden: jnp.ndarray          # [nlayer] g/cm^2
    mmw_layer: jnp.ndarray       # [nlayer] amu
    mix: jnp.ndarray             # [nmol, nlayer] mixing ratios
    electrons: jnp.ndarray       # [nlayer]
    z: jnp.ndarray               # [nlevel] cm
    dz: jnp.ndarray              # [nlevel] cm
    cld_opd: jnp.ndarray         # [nlayer, nwno]
    cld_g0: jnp.ndarray
    cld_w0: jnp.ndarray
    sigma_ray: jnp.ndarray       # [nray, nwno] rayleigh cross sections
    mix_ray: jnp.ndarray         # [nray, nlayer]
    ubar0: jnp.ndarray           # [ng, nt]
    ubar1: jnp.ndarray
    gweight: jnp.ndarray
    tweight: jnp.ndarray
    F0PI: jnp.ndarray            # [nwno]
    surf_reflect: jnp.ndarray    # [nwno]
    rstar: jnp.ndarray           # scalar (cm)
    cos_theta: jnp.ndarray       # scalar cos(phase angle)
    # Raman inputs (empty [.., 0] / neutral when raman is off):
    raman_shifts: jnp.ndarray    # [nrow, nwno] raman-shifted star ratios
    raman_c: jnp.ndarray         # [nrow] cross-section coefficients
    raman_ji: jnp.ndarray        # [nrow] initial J levels (int32)
    raman_dnu: jnp.ndarray       # [nrow] wavenumber shifts
    raman_pollack_row: jnp.ndarray  # [nwno] legacy Pollack factor


@dataclasses.dataclass(frozen=True)
class SpectrumConfig:
    """Static compilation-defining options."""
    mol_indices: Tuple[int, ...]          # rows of grid.log_kappa to use
    continuum_specs: Tuple[assemble.ContinuumSpec, ...]
    cont_indices: Tuple[int, ...]         # rows of grid.cont_opa per spec
    mix_index: Tuple[Tuple[str, int], ...]  # molecule name -> row in mix
    controls: toon.ScatteringControls = toon.ScatteringControls()
    raman: int = 2                        # 0 oklopcic 1 pollack 2 none
    delta_eddington: bool = True
    stream: int = 2
    # RT scheme: 0 = Toon89 two-stream (fluxes.py:1010/:1683), 1 = Rooney
    # spherical-harmonics 2/4-stream (fluxes.py:2675/:2979, `stream` picks
    # 2 vs 4).  SH integer options follow config.json approx.rt_params.SH.
    rt_method: int = 0
    sh_w_single_form: int = 0
    sh_w_multi_form: int = 0
    sh_psingle_form: int = 0
    sh_w_single_rayleigh: int = 1
    sh_w_multi_rayleigh: int = 1
    sh_psingle_rayleigh: int = 1
    sh_single_form: int = 0
    # SH working precision: 'auto' = f64 when x64 is enabled (oracle-
    # compatible), else the f32 incoming-grouping path (rt/sh.py
    # precision note; max relative error ~2e-3 against the f64 path)
    sh_precision: str = 'auto'
    test_mode: Optional[str] = None
    hard_surface: bool = False
    reflected: bool = True
    thermal: bool = True
    transmission: bool = False

    def mix_row(self, name):
        return dict(self.mix_index)[name]


def _raman_factor(config, scene, wno, nwno):
    """Raman single-scattering factor [nlayer, nwno] — same three modes as
    the stepwise API (justdoit raman wiring / optics.py:286-306): 0 =
    Oklopcic (in-jit, from the scene's precomputed stellar shift ratios),
    1 = Pollack (precomputed row), 2 = none."""
    nlayer = scene.tlayer.shape[0]
    dtype = scene.cld_opd.dtype
    if config.raman == 0:
        from .raman import raman_factor_oklopcic
        rf = raman_factor_oklopcic(wno, scene.raman_shifts.T, scene.tlayer,
                                   scene.raman_c, scene.raman_ji,
                                   scene.raman_dnu)
        return jnp.minimum(rf, 0.99999).astype(dtype)
    if config.raman == 1:
        row = jnp.minimum(scene.raman_pollack_row, 0.99999).astype(dtype)
        return jnp.broadcast_to(row[None, :], (nlayer, nwno))
    return jnp.full((nlayer, nwno), 0.99999, dtype)


def gather_taugas(scene: SceneTensors, grid: OpacityGrid,
                  config: SpectrumConfig):
    """The molecular-opacity gather stage alone: taugas [nlayer, nwno].

    Exactly the first stage of :func:`forward`, exposed so the benchmark
    can time the memory-bound gather on its own."""
    mix_cols = scene.mix[jnp.asarray([dict(config.mix_index)[grid.molecules[i]]
                                      for i in config.mol_indices])]
    kappa = interp_molecular(grid, scene.tlayer, scene.player / PCONV)
    kappa = kappa[jnp.asarray(config.mol_indices)]
    return assemble.molecular_tau(kappa, mix_cols, scene.colden,
                                  scene.mmw_layer)


def _toon_scan(tg, tr, rf, scene, grid, config):
    """Toon89 TOA solve through the XLA scan path (rt/toon.py).

    Returns (xint [ng, nt, nwno] or None, flux_top or None, dtau_og)."""
    props = combine_optics(tg, tr, scene.cld_opd, scene.cld_w0,
                           scene.cld_g0, rf, test_mode=config.test_mode,
                           delta_eddington=config.delta_eddington,
                           stream=config.stream)
    xint = flux_top = None
    if config.reflected:
        xint, _ = toon.reflected_1d(
            props.dtau, props.tau, props.w0, props.cosb, props.gcos2,
            props.ftau_cld, props.ftau_ray, props.dtau_og, props.tau_og,
            props.w0_og, props.cosb_og, scene.surf_reflect, scene.ubar0,
            scene.ubar1, scene.cos_theta, scene.F0PI,
            controls=config.controls, get_toa_intensity=True,
            get_lvl_flux=False)
    if config.thermal:
        flux_top, _ = toon.thermal_1d(
            scene.tlevel, props.dtau_og, props.w0_no_raman, props.cosb_og,
            scene.plevel, scene.ubar1, scene.surf_reflect, grid.wno,
            dwno=jnp.zeros(grid.wno.shape[0]),
            hard_surface=config.hard_surface, calc_type=0)
    return xint, flux_top, props.dtau_og


def _toon_kernel(tg, tr, rf, scene, grid, config):
    """The same contract as :func:`_toon_scan` through the fused GPU
    kernel (rt/toon_kernel.py)."""
    from .rt.toon_kernel import toon_spectrum
    dtype = tg.dtype
    all_b = toon.blackbody(scene.tlevel, 1.0 / grid.wno).astype(dtype)
    ptfac = scene.plevel[0] / (scene.plevel[1] - scene.plevel[0])
    xint, flux_top = toon_spectrum(
        tg, tr, scene.cld_opd, scene.cld_w0, scene.cld_g0, rf, all_b, ptfac,
        scene.surf_reflect, scene.ubar0, scene.ubar1, scene.cos_theta,
        scene.F0PI, controls=config.controls, stream=config.stream,
        delta_eddington=config.delta_eddington,
        hard_surface=config.hard_surface, reflected=config.reflected,
        thermal=config.thermal)
    return xint, flux_top, tg + tr + scene.cld_opd


def _toon_solve(tg, tr, rf, scene, grid, config):
    """Toon89 TOA solve for the backend being lowered for: the fused
    kernel on CUDA, the scan path elsewhere.  The analytic test modes
    overwrite the optics, so they always take the scan path."""
    if config.test_mode is not None or not (config.reflected
                                            or config.thermal):
        return _toon_scan(tg, tr, rf, scene, grid, config)
    return jax.lax.platform_dependent(
        tg, tr, rf, scene, grid,
        cuda=partial(_toon_kernel, config=config),
        default=partial(_toon_scan, config=config))


def _forward(scene, grid, config, toon_rt):
    """Body of :func:`forward`; ``toon_rt`` is the Toon89 TOA solve."""
    nwno = grid.wno.shape[0]
    nlayer = scene.tlayer.shape[0]
    dtype = scene.cld_opd.dtype

    # ---- gas optics (device-memory gather + fused arithmetic) ----
    taugas = gather_taugas(scene, grid, config)
    if config.continuum_specs:
        cont = nearest_continuum(grid, scene.tlayer)
        # layer gravity recovered from the column-density definition
        # colden = dP/g (atmsetup.py:549-555)
        gravity_layer = (scene.plevel[1:] - scene.plevel[:-1]) / scene.colden
        coef1 = assemble.amagat_coef1(
            scene.tlevel, scene.plevel / PCONV, scene.tlayer,
            scene.player / PCONV, gravity_layer, scene.mmw_layer)
        mix_named = {name: scene.mix[row] for name, row in config.mix_index}
        cont_kappa = {spec.name: cont[ci] for spec, ci in
                      zip(config.continuum_specs, config.cont_indices)}
        for spec in config.continuum_specs:
            for m in (spec.mol1, spec.mol2):
                if m and m not in mix_named:
                    mix_named[m] = jnp.zeros(nlayer, dtype)
        taugas = taugas + assemble.continuum_tau(
            config.continuum_specs, cont_kappa, mix_named, scene.electrons,
            coef1, scene.player, scene.tlayer, scene.colden,
            scene.mmw_layer)

    tauray = assemble.rayleigh_tau(scene.sigma_ray, scene.mix_ray,
                                   scene.colden, scene.mmw_layer)
    rf = _raman_factor(config, scene, grid.wno, nwno)

    tg = taugas.astype(dtype)
    tr = tauray.astype(dtype)
    out = {}
    if config.rt_method == 0:
        xint, flux_top, dtau_og = toon_rt(tg, tr, rf, scene, grid, config)
        if xint is not None:
            out['albedo'] = disco_mod.compress_disco(
                xint, scene.gweight, scene.tweight, scene.cos_theta,
                scene.F0PI)
        if flux_top is not None:
            out['thermal'] = disco_mod.compress_thermal(
                flux_top, scene.gweight, scene.tweight)
        if config.transmission:
            out['transit_depth'] = transit_depth(
                scene.z, scene.dz, scene.rstar, scene.mmw_layer,
                scene.plevel, scene.tlevel, scene.colden, dtau_og)
        return out

    props = combine_optics(tg, tr, scene.cld_opd, scene.cld_w0,
                           scene.cld_g0, rf, test_mode=config.test_mode,
                           delta_eddington=config.delta_eddington,
                           stream=config.stream)
    from .rt import sh as sh_mod
    if config.reflected:
        xint = sh_mod.reflected_sh(
            props, scene.surf_reflect, scene.ubar0, scene.ubar1,
            scene.cos_theta, scene.F0PI, stream=config.stream,
            controls=config.controls,
            w_single_form=config.sh_w_single_form,
            w_multi_form=config.sh_w_multi_form,
            psingle_form=config.sh_psingle_form,
            w_single_rayleigh=config.sh_w_single_rayleigh,
            w_multi_rayleigh=config.sh_w_multi_rayleigh,
            psingle_rayleigh=config.sh_psingle_rayleigh,
            single_form=config.sh_single_form,
            precision=config.sh_precision)
        out['albedo'] = disco_mod.compress_disco(
            xint, scene.gweight, scene.tweight, scene.cos_theta,
            scene.F0PI)
    if config.thermal:
        flux_top, _ = sh_mod.thermal_sh(
            scene.tlevel, props, scene.plevel, scene.ubar1,
            scene.surf_reflect, grid.wno, stream=config.stream,
            hard_surface=config.hard_surface,
            precision=config.sh_precision)
        out['thermal'] = disco_mod.compress_thermal(
            flux_top, scene.gweight, scene.tweight)
    if config.transmission:
        out['transit_depth'] = transit_depth(
            scene.z, scene.dz, scene.rstar, scene.mmw_layer,
            scene.plevel, scene.tlevel, scene.colden, props.dtau_og)
    return out


@partial(jax.jit, static_argnames=('config',))
def forward(scene: SceneTensors, grid: OpacityGrid,
            config: SpectrumConfig):
    """Full 1D spectrum in one compiled program.

    Returns a dict of device arrays: albedo [nwno], thermal flux [nwno],
    transit depth [nwno] (keys present per config flags).
    """
    return _forward(scene, grid, config, _toon_solve)


@partial(jax.jit, static_argnames=('config',))
def forward_reference(scene: SceneTensors, grid: OpacityGrid,
                      config: SpectrumConfig):
    """:func:`forward` with the XLA scan Toon solve on every backend: the
    plain reference the GPU kernel is checked and timed against."""
    return _forward(scene, grid, config, _toon_scan)


def stack_scenes(scenes):
    """Stack same-shaped SceneTensors along a new leading batch axis.

    The batch axis is the framework's data-parallel unit: phase-curve
    points, retrieval live points, or grid members — one program, one
    dispatch, shardable over a mesh 'batch' axis (parallel.shard_scene
    with batched=True).  Replaces the reference's joblib/serial loops
    (justdoit.py:4741-4777).

    Host-resident leaves stack with numpy (one device transfer at
    dispatch instead of one jnp.stack dispatch per leaf — 20x faster
    for scenes built by scene_from_arrays)."""
    def _stack(*xs):
        if all(isinstance(x, np.ndarray) or np.isscalar(x) for x in xs):
            return np.stack(xs)
        return jnp.stack(xs)
    batch = jax.tree_util.tree_map(_stack, *scenes)
    # batch-constancy of the scalarish fields is decided HERE, where the
    # per-scene leaves are host data (or the same device object), so
    # forward_batch never forces a device->host readback in the hot loop
    updates = {}
    for name in _SCALARISH_RANK:
        leaves = [getattr(s, name) for s in scenes]
        first = leaves[0]
        same = all(l is first for l in leaves) or (
            all(isinstance(l, np.ndarray) or np.isscalar(l)
                for l in leaves)
            and all(np.array_equal(l, first) for l in leaves[1:]))
        if same:
            updates[name] = first
    return batch._replace(**updates)


# small per-scene geometry fields: across a retrieval batch they are
# identical, so they stay unbatched (the Toon kernel then reads one copy
# of the disk angles for the whole batch).
# Values are each field's UNBATCHED rank: stack_scenes leaves a
# batch-constant field at this rank, and forward_batch reads only the
# rank (never the data) to pick the vmap axis.
_SCALARISH_RANK = {'ubar0': 2, 'ubar1': 2, 'gweight': 1, 'tweight': 1,
                   'cos_theta': 0, 'F0PI': 1, 'surf_reflect': 1}


def forward_batch(scenes: SceneTensors, grid: OpacityGrid,
                  config: SpectrumConfig):
    """Batched fused forward (jit rides on the inner ``forward``):
    scenes carry a leading batch axis on every field (from
    :func:`stack_scenes`); outputs gain the same axis.

    Geometry-like fields that are identical across the batch (the
    retrieval case — same disk nodes, different atmospheres) stay
    unbatched (stack_scenes leaves them at their per-scene rank); fields
    that genuinely vary per scene (phase curves) keep their batch axis.
    Hand-stacked inputs with a batch axis on everything work too."""
    axes = {}
    for name, val in scenes._asdict().items():
        rank = _SCALARISH_RANK.get(name)
        if rank is not None and (val is None or np.ndim(val) == rank):
            axes[name] = None
        else:
            axes[name] = 0
    return jax.vmap(lambda s: forward(s, grid, config),
                    in_axes=(SceneTensors(**axes),))(scenes)


def scene_from_arrays(profile_bar, t_level, mix_named, grid: OpacityGrid,
                      gravity, radius=np.nan, mass=np.nan, p_reference=1.0,
                      num_gangle=10, cld=None, F0PI=None, rstar=np.nan,
                      rayleigh_species=None, dtype=np.float32,
                      geom=None, surf_reflect=None,
                      raman_shifts=None, raman_db=None,
                      raman_pollack_row=None):
    """Build (SceneTensors, SpectrumConfig) from plain arrays.

    Host-side, once per scene structure; afterwards ``forward`` is pure
    device compute.
    """
    from .atmosphere import build_atmosphere
    from .rayleigh import rayleigh_sigma_table, RAYLEIGH_MOLECULES

    prof = {'pressure': profile_bar, 'temperature': t_level}
    prof.update(mix_named)
    wno = np.asarray(grid.wno)
    atm = build_atmosphere(prof, gravity=gravity, radius=radius, mass=mass,
                           p_reference=p_reference, wno=wno,
                           cld_profile=cld, cld_wno=None if cld is None
                           else wno)
    if geom is None:
        geom = disco_mod.make_geometry(0.0, num_gangle=num_gangle,
                                       num_tangle=1)

    used = [m for m in atm.molecules if m in grid.molecules]
    mol_indices = tuple(grid.molecules.index(m) for m in used)
    mix_index = tuple((m, i) for i, m in enumerate(atm.molecules))
    pairs = atm.continuum_pairs(grid.continuum_molecules)
    specs = tuple(assemble.classify_continuum(pairs))
    cont_indices = tuple(grid.continuum_molecules.index(s.name)
                         for s in specs)

    ray_species = (rayleigh_species if rayleigh_species is not None
                   else atm.rayleigh_species(RAYLEIGH_MOLECULES))
    sig_table = rayleigh_sigma_table(wno, ray_species)
    sigma_ray = (np.stack([sig_table[m] for m in ray_species])
                 if ray_species else np.zeros((0, len(wno))))
    mix_ray = (np.stack([atm.mixing_ratio_layer(m) for m in ray_species])
               if ray_species else np.zeros((0, atm.nlayer)))

    nwno = len(wno)
    zeros_cld = np.zeros((atm.nlayer, nwno), dtype)
    scene = SceneTensors(
        tlevel=jnp.asarray(atm.temperature, dtype),
        plevel=jnp.asarray(atm.pressure, dtype),
        tlayer=jnp.asarray(atm.t_layer, dtype),
        player=jnp.asarray(atm.p_layer, dtype),
        colden=jnp.asarray(atm.colden, dtype),
        mmw_layer=jnp.asarray(atm.mmw_layer, dtype),
        mix=jnp.asarray(atm.mixingratios_layer.T, dtype),
        electrons=jnp.asarray(atm.electrons_layer
                              if atm.electrons_layer is not None
                              else np.zeros(atm.nlayer), dtype),
        z=jnp.asarray(atm.z, dtype), dz=jnp.asarray(atm.dz, dtype),
        cld_opd=jnp.asarray(atm.cld_opd if atm.cld_opd is not None
                            else zeros_cld, dtype),
        cld_g0=jnp.asarray(atm.cld_g0 if atm.cld_g0 is not None
                           else zeros_cld, dtype),
        cld_w0=jnp.asarray(atm.cld_w0 if atm.cld_w0 is not None
                           else zeros_cld, dtype),
        sigma_ray=jnp.asarray(sigma_ray, dtype),
        mix_ray=jnp.asarray(mix_ray, dtype),
        ubar0=jnp.asarray(geom.ubar0, dtype),
        ubar1=jnp.asarray(geom.ubar1, dtype),
        gweight=jnp.asarray(geom.gweight, dtype),
        tweight=jnp.asarray(geom.tweight, dtype),
        F0PI=jnp.asarray(F0PI if F0PI is not None else np.ones(nwno),
                         dtype),
        surf_reflect=(jnp.zeros(nwno, dtype) if surf_reflect is None
                      else jnp.broadcast_to(
                          jnp.asarray(surf_reflect, dtype), (nwno,))),
        rstar=jnp.asarray(rstar, dtype),
        cos_theta=jnp.asarray(getattr(geom, 'cos_theta', 1.0), dtype),
        raman_shifts=(jnp.asarray(np.asarray(raman_shifts).T, dtype)
                      if raman_shifts is not None
                      else jnp.zeros((0, nwno), dtype)),
        raman_c=(jnp.asarray(raman_db['c'].values, dtype)
                 if raman_db is not None else jnp.zeros(0, dtype)),
        raman_ji=(jnp.asarray(raman_db['ji'].values, jnp.int32)
                  if raman_db is not None else jnp.zeros(0, jnp.int32)),
        raman_dnu=(jnp.asarray(raman_db['deltanu'].values, dtype)
                   if raman_db is not None else jnp.zeros(0, dtype)),
        raman_pollack_row=(jnp.asarray(raman_pollack_row, dtype)
                           if raman_pollack_row is not None
                           else jnp.ones(nwno, dtype)))
    config = SpectrumConfig(mol_indices=mol_indices,
                            continuum_specs=specs,
                            cont_indices=cont_indices,
                            mix_index=mix_index,
                            transmission=np.isfinite(rstar))
    return scene, config


def scene_from_case(case, opa, dtype=np.float32):
    """SceneTensors/SpectrumConfig from a justdoit.inputs bundle.

    Translates the full approx tree (justdoit.py:4635 semantics) into the
    static config — rt scheme (Toon/SH + stream), phase-function controls,
    delta-Eddington, and the Raman mode, so the fused path runs the same
    physics as the stepwise API for every approx setting.
    """
    import dataclasses as _dc

    prof = case.inputs['atmosphere']['profile']
    mix = {c: np.asarray(prof[c]) for c in prof.keys()
           if c not in ('pressure', 'temperature')}
    cld = None
    if case.inputs['clouds'].get('profile') is not None:
        from .wavelength import regrid
        cp = case.inputs['clouds']['profile']
        nlayer = len(prof['pressure']) - 1
        cld_wno = case.inputs['clouds']['wavenumber']
        cld = {}
        for k in ('opd', 'g0', 'w0'):
            m = np.reshape(np.asarray(cp[k]), (nlayer, len(cld_wno)))
            cld[k] = regrid(m, cld_wno, np.asarray(opa.wno)).ravel()
    planet = case.inputs['planet']

    approx = case.inputs['approx']
    common = approx['rt_params']['common']
    toon_p = approx['rt_params']['toon']
    sh = approx['rt_params']['SH']
    raman = common['raman']
    nlayer = len(np.asarray(prof['pressure'])) - 1

    raman_shifts = raman_db = pollack_row = None
    if raman == 0:
        if getattr(opa, 'raman_stellar_shifts', None) is None:
            raise ValueError("raman='oklopcic' needs star() run first")
        raman_shifts = np.asarray(opa.raman_stellar_shifts)
        raman_db = opa.raman_db
    elif raman == 1:
        from .raman import raman_factor_pollack
        from .refdata import refdata_path
        pollack_row = raman_factor_pollack(
            1, 1e4 / np.asarray(opa.wno),
            refdata_dir=os.path.dirname(os.path.dirname(
                refdata_path('opacities', 'raman.txt'))))[0]

    scene, config = scene_from_arrays(
        np.asarray(prof['pressure']), np.asarray(prof['temperature']), mix,
        opa.grid, gravity=planet['gravity'] or np.nan,
        radius=planet['radius'] or np.nan, mass=planet['mass'] or np.nan,
        p_reference=approx['p_reference'],
        cld=cld,
        F0PI=(np.asarray(opa.relative_flux)
              if opa.relative_flux is not None else None),
        rstar=case.inputs['star'].get('radius', np.nan)
        if isinstance(case.inputs['star'].get('radius'), float) else np.nan,
        dtype=dtype,
        geom=case.inputs.get('disco'),
        surf_reflect=case.inputs.get('surface_reflect', 0.0),
        raman_shifts=raman_shifts, raman_db=raman_db,
        raman_pollack_row=pollack_row)

    frac = common['TTHG_params']['fraction']
    controls = toon.ScatteringControls(
        single_phase=toon_p['single_phase'],
        multi_phase=toon_p['multi_phase'],
        toon_coefficients=toon_p.get('toon_coefficients', 0),
        frac_a=frac[0], frac_b=frac[1], frac_c=frac[2],
        constant_back=common['TTHG_params']['constant_back'],
        constant_forward=common['TTHG_params']['constant_forward'])
    config = _dc.replace(
        config, controls=controls, raman=raman,
        delta_eddington=common['delta_eddington'],
        stream=common['stream'],
        rt_method=1 if approx['rt_method'] == 'SH' else 0,
        sh_w_single_form=sh['w_single_form'],
        sh_w_multi_form=sh['w_multi_form'],
        sh_psingle_form=sh['psingle_form'],
        sh_w_single_rayleigh=sh['w_single_rayleigh'],
        sh_w_multi_rayleigh=sh['w_multi_rayleigh'],
        sh_psingle_rayleigh=sh['psingle_rayleigh'],
        sh_single_form=sh['single_form'],
        hard_surface=bool(case.inputs.get('hard_surface', 0)))
    return scene, config
