"""Device-mesh parallelism for spectra, phase curves, and retrievals.

The reference scales by joblib processes and MPI ranks (SURVEY.md §2.4);
here the parallel axes are proper mesh axes of single SPMD programs:

* ``wave``  — the wavelength grid (nwno up to ~5e4 monochromatic points) is
  embarrassingly parallel through the whole RT stack: every kernel treats
  wavelength as the vector axis, so sharding it across devices needs zero
  collectives until the final spectral integrals (bond albedo, Teff), which
  XLA lowers to a single psum over the wave axis.
* ``batch`` — independent scenes (phase-curve points, grid-fit members,
  retrieval live points) vmapped and sharded data-parallel.

Shard layout: every [..., nwno] array splits on its last axis; the opacity
grid's [nmol, npt, nwno] cube likewise, so each chip holds only its slice of
the database (the key to fitting full-resolution opacities in device memory).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .opacities.db import OpacityGrid, PTGrid
from .pipeline import SceneTensors, forward

__all__ = ['make_mesh', 'scene_specs', 'grid_specs', 'shard_scene',
           'shard_grid', 'sharded_forward', 'shard_climate',
           'shard_climate_state', 'sharded_loglike']


def make_mesh(n_wave=None, n_batch=1, devices=None):
    """('batch', 'wave') mesh over the available devices."""
    devices = devices if devices is not None else jax.devices()
    if n_wave is None:
        n_wave = len(devices) // n_batch
    dev = np.asarray(devices[:n_batch * n_wave]).reshape(n_batch, n_wave)
    return Mesh(dev, axis_names=('batch', 'wave'))


def _wave_sharded_fields():
    """SceneTensors fields carrying a trailing wavelength axis."""
    return {'cld_opd', 'cld_g0', 'cld_w0', 'sigma_ray', 'F0PI',
            'surf_reflect', 'raman_shifts', 'raman_pollack_row'}


def scene_specs(scene: SceneTensors, batched: bool = False) -> SceneTensors:
    """PartitionSpec per scene field: wave-sharded where the field has a
    wno axis, replicated otherwise; with ``batched`` the leading axis of
    each batched field shards over 'batch'."""
    from .pipeline import _SCALARISH_RANK
    out = {}
    for name, val in scene._asdict().items():
        # stack_scenes leaves batch-constant scalarish fields at their
        # unbatched rank: no batch dim even when the rest is batched
        rank = _SCALARISH_RANK.get(name)
        lead = (('batch',) if batched
                and not (rank is not None and np.ndim(val) == rank) else ())
        if name in _wave_sharded_fields():
            out[name] = P(*lead, *((None,) * (np.ndim(val) - 1 - len(lead))),
                          'wave')
        else:
            out[name] = P(*lead) if lead and np.ndim(val) else P()
    return SceneTensors(**out)


def grid_specs(grid: OpacityGrid) -> OpacityGrid:
    """PartitionSpec per opacity-grid field: the cube and every array
    with a wno axis shard over 'wave', the (T, P) grid is replicated."""
    return OpacityGrid(wno=P('wave'), log_kappa=P(None, None, 'wave'),
                       pt=PTGrid(P(), P(), P(), P()),
                       cont_opa=P(None, None, 'wave'), cia_temps=P(),
                       molecules=grid.molecules,
                       continuum_molecules=grid.continuum_molecules)


def shard_scene(scene: SceneTensors, mesh: Mesh,
                batched: bool = False) -> SceneTensors:
    """Place scene arrays: wave-sharded where they have a wno axis,
    replicated otherwise.  With ``batched`` the leading axis is the batch
    axis and shards over 'batch'."""
    return jax.tree_util.tree_map(
        lambda x, spec: jax.device_put(x, NamedSharding(mesh, spec)),
        scene, scene_specs(scene, batched))


def shard_grid(grid: OpacityGrid, mesh: Mesh) -> OpacityGrid:
    """Shard the opacity database cube over the wave axis of the mesh."""
    return jax.tree_util.tree_map(
        lambda x, spec: jax.device_put(x, NamedSharding(mesh, spec)),
        grid, grid_specs(grid))


@partial(jax.jit, static_argnames=('config', 'mesh', 'batched'))
def sharded_forward(scene, grid, config, mesh, batched=False):
    """Run the fused pipeline SPMD over the mesh.

    Every stage of :func:`~picaso_tpu.pipeline.forward` is local to a
    wavelength, so each device runs the whole forward (the fused GPU
    kernel included) on its own slice of the wavelength grid and, with
    ``batched`` (scenes from ``stack_scenes``), of the batch: the program
    has no collective.  Outputs are [.., nwno] sharded the same way.
    """
    from .pipeline import forward_batch
    fwd = forward_batch if batched else forward
    lead = ('batch',) if batched else ()
    keys = [k for k, on in (('albedo', config.reflected),
                            ('thermal', config.thermal),
                            ('transit_depth', config.transmission)) if on]
    return jax.shard_map(
        lambda s, g: fwd(s, g, config), mesh=mesh,
        in_specs=(scene_specs(scene, batched), grid_specs(grid)),
        out_specs={k: P(*lead, 'wave') for k in keys},
        check_vma=False)(scene, grid)


def shard_climate_state(state, mesh: Mesh):
    """Wave-shard a :class:`~picaso_tpu.climate.api._ClimateState` in
    place so the FULL climate solve (``run_climate``: profile passes +
    find_strat) runs SPMD over the mesh's 'wave' axis.

    The host-side orchestration (convective-zone state machine,
    convergence checks) is untouched; every fused Newton dispatch inside
    it then consumes wave-sharded CK/optics arrays, so the per-iteration
    spectral integrals lower to psums over 'wave'.  This is the
    whole-solve analog of :func:`shard_climate` (which places one
    batched ``profile_step``)."""
    import copy

    _, data, ck_arrays = shard_climate(None, state.data, state.ck.arrays,
                                       mesh)
    state.data = data
    # shallow-copy the (mutable, host-side) CKTable so the caller's
    # opacity connection keeps its unsharded arrays
    state.ck = copy.copy(state.ck)
    state.ck.arrays = ck_arrays
    return state


def sharded_loglike(loglike_vec, mesh: Mesh):
    """Wrap a vectorized ``[n, ndim] -> [n]`` log-likelihood so nested-
    sampling batches shard over the mesh 'batch' axis.

    The returned callable pads each batch up to a multiple of the mesh
    batch size, places it with a ('batch', None) sharding, and returns
    host numpy — a drop-in ``loglike_fn`` for
    :func:`picaso_tpu.sampler.nested_sample(vectorized=True)`.  Combined
    with a forward model that closed over ``shard_scene``/``shard_grid``
    arrays, live points parallelize over 'batch' and wavelength over
    'wave' — the SPMD replacement for the reference's MPI likelihood
    pool (driver.py:406-427).
    """
    nb = int(mesh.shape['batch'])
    sh = NamedSharding(mesh, P('batch', None))

    def wrapped(x):
        x = np.asarray(x)
        n = x.shape[0]
        npad = (-n) % nb
        xp = (np.concatenate([x, np.repeat(x[-1:], npad, 0)])
              if npad else x)
        out = np.asarray(loglike_vec(jax.device_put(xp, sh)))
        return out[:n]

    return wrapped


def shard_climate(temps, data, ck_arrays, mesh: Mesh):
    """Place a batched climate problem on the mesh.

    ``temps`` [n_batch, nlevel] shards over 'batch' (independent scenes —
    a Teff/gravity grid, coupled-map columns); every wavelength-bearing
    array in :class:`~picaso_tpu.climate.fused.ClimateData` and
    :class:`~picaso_tpu.opacities.ck.CKArrays` shards over 'wave' (the
    CK-bin axis).  The per-iteration spectral integrals inside the fused
    Newton solve then lower to psums over 'wave', and any cross-scene
    reduction to a psum over 'batch' — the climate analog of the forward
    pipeline's mesh layout.
    """
    batch = NamedSharding(mesh, P('batch', None))
    rep = NamedSharding(mesh, P())
    w_last = NamedSharding(mesh, P(None, 'wave'))

    if temps is not None:
        temps = jax.device_put(jnp.asarray(temps), batch)

    def put_wave_last(x):
        return jax.device_put(
            x, NamedSharding(mesh, P(*(None,) * (x.ndim - 1), 'wave')))

    data = data._replace(
        F0PI=put_wave_last(data.F0PI),
        surf_reflect=put_wave_last(data.surf_reflect),
        sigma_ray=put_wave_last(data.sigma_ray),
        cld_opd=put_wave_last(data.cld_opd),
        cld_g0=put_wave_last(data.cld_g0),
        cld_w0=put_wave_last(data.cld_w0),
        **{f: jax.device_put(getattr(data, f), rep)
           for f in ('plevel', 'gravity', 'tidal', 'rfaci', 'rfacv',
                     'tmin', 'tmax', 'cond_abunds')})
    ck_arrays = ck_arrays._replace(
        wno=put_wave_last(ck_arrays.wno),
        delta_wno=put_wave_last(ck_arrays.delta_wno),
        ln_kappa=jax.device_put(
            ck_arrays.ln_kappa, NamedSharding(mesh, P(None, None, 'wave',
                                                      None))),
        cont_opa=jax.device_put(
            ck_arrays.cont_opa, NamedSharding(mesh, P(None, None, 'wave'))),
        gauss_wts=jax.device_put(ck_arrays.gauss_wts, rep),
        p_log_grid=jax.device_put(ck_arrays.p_log_grid, rep),
        t_inv_grid=jax.device_put(ck_arrays.t_inv_grid, rep),
        nc_p=jax.device_put(ck_arrays.nc_p, rep),
        cia_temps=jax.device_put(ck_arrays.cia_temps, rep))
    del w_last
    return temps, data, ck_arrays
