"""Smoke test of picaso_tpu on one NVIDIA GPU, through the user entry points.

Phases, each on its own lines; any failure exits non-zero:

0. the card: its name and power limit from nvidia-smi, the JAX version,
   whether pandas and h5py import.  Without a GPU the script stops here.
1. the production-shape forward (ragged 1060-point PT grid, 16 molecules,
   nwno = 50,000, 91 levels, cloudy, 10 disk angles): reflected, thermal
   and transit spectra, the steady-state rate, and the fused Toon kernel
   against the XLA scan path (``pipeline.forward_reference``) at full
   width; then a spectrum through the user API
   (``opannection`` -> ``inputs`` -> ``spectrum``) against the same call
   in float64 on the host CPU.
2. GPU float32 against the repo's float64 path on the host CPU, in this
   process: Toon at nwno = 5,000 and SH4 at nwno = 2,000, both cut from
   the production wavelength grid (wavelengths are independent, so every
   other width of the problem stays).
3. ``forward_batch`` of 8 production-shape scenes and a chi^2
   likelihood over them.
4. a 91-level brown-dwarf radiative-convective-equilibrium solve
   (``case.climate``, which runs in float64), converged, against the same
   solve on the host CPU.

With ``--four-cards`` only the mesh path runs: a ('batch', 'wave') mesh
over four GPUs, the sharded forward, likelihood and RCE solve, each
against one card.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

    python chip_smoke.py
    python chip_smoke.py --four-cards
"""

import argparse
import json
import subprocess
import sys
import time

import numpy as np

NWNO = 50_000
TOON_CUT = 10       # nwno 5,000 for the CPU float64 parity
SH_CUT = 25         # nwno 2,000
N_TIMED = 20

# (max, median) relative error bounds against the float64 CPU path: f32
# exp/log through 90-layer recurrences (Toon); the f32 SH block solve
# keeps ~2e-3 (rt/sh.py precision note)
TOON_TOL = (5e-3, 2e-4)
SH4_TOL = 8e-3
KERNEL_TOL = 1e-4   # fused kernel vs XLA scan, both f32: summation order
# the user-API scene (a cold Jupiter) has layers of dtau ~1.5e-5 at its
# 5 um thermal peak: the linear-in-tau source terms there cancel pieces
# ~1/dtau larger than the flux, so f32 keeps ~eps_f32 / dtau ~ 4e-3 of
# the peak on any backend (PERF.md); bound: 5x that, peak-normalized
USER_API_TOL = 2e-2
CLIMATE_TOL_K = 2.0
MESH_CLIMATE_TOL_K = 0.5


class SmokeFailure(RuntimeError):
    pass


def rel_err(a, b, floor=0.0):
    """(max, median) of |a - b| / max(|b|, floor) over all elements."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise SmokeFailure(f'shape {a.shape} != {b.shape}')
    if not np.isfinite(a).all():
        raise SmokeFailure(f'{int((~np.isfinite(a)).sum())} non-finite values')
    err = np.abs(a - b) / np.maximum(np.abs(b), floor)
    return float(err.max()), float(np.median(err))


def peak_err(a, b):
    """max |a - b| / max |b|: the error as a share of the spectrum's peak."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape or not np.isfinite(a).all():
        raise SmokeFailure(f'shape {a.shape} vs {b.shape}, '
                           f'{int((~np.isfinite(a)).sum())} non-finite')
    return float(np.abs(a - b).max() / np.abs(b).max())


def check(label, value, limit):
    """Print ``value`` beside its bound and fail if it exceeds it."""
    ok = bool(np.isfinite(value) and value <= limit)
    print(f'  {label}: {value:.3e} (limit {limit:.1e}) '
          f'{"ok" if ok else "FAILED"}', flush=True)
    if not ok:
        raise SmokeFailure(f'{label} = {value:.3e} exceeds {limit:.1e}')


def finite(label, x, shape):
    x = np.asarray(x)
    if x.shape != shape or not np.isfinite(x).all():
        raise SmokeFailure(f'{label}: shape {x.shape} (want {shape}), '
                           f'{int((~np.isfinite(x)).sum())} non-finite')


def card_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def steady_rate(fn, scenes):
    """Spectra per second over N_TIMED perturbed calls, median of 3."""
    import jax
    jax.block_until_ready(fn(scenes[0]))
    rates = []
    for _ in range(3):
        t0 = time.perf_counter()
        for s in scenes[1:N_TIMED + 1]:
            out = fn(s)
        jax.block_until_ready(out)
        rates.append(N_TIMED / (time.perf_counter() - t0))
    return float(np.median(rates))


def perturbed(scene, n):
    return [scene._replace(tlevel=scene.tlevel * (1 + 0.001 * i),
                           tlayer=scene.tlayer * (1 + 0.001 * i))
            for i in range(n + 1)]


def cut(scene, grid, step):
    """Every ``step``-th wavelength of a scene and its opacity grid."""
    from picaso_tpu import parallel
    sl = lambda x, spec: (x[..., ::step]  # noqa: E731
                          if spec and spec[-1] == 'wave' else x)
    import jax
    return (jax.tree_util.tree_map(sl, scene, parallel.scene_specs(scene)),
            jax.tree_util.tree_map(sl, grid, parallel.grid_specs(grid)))


def on_cpu64(fn, *trees):
    """Run ``fn`` in float64 on the host CPU backend, in this process."""
    import jax

    def f64(x):
        x = np.asarray(x)
        return x.astype(np.float64) if np.issubdtype(x.dtype,
                                                     np.floating) else x
    with jax.enable_x64(True), jax.default_device(jax.devices('cpu')[0]):
        args = [jax.tree_util.tree_map(f64, t) for t in trees]
        return jax.tree_util.tree_map(np.asarray, fn(*args))


def phase0(expect):
    import jax
    devices = jax.devices()
    if devices[0].platform != 'gpu' or len(devices) < expect:
        print(f'no GPU backend with {expect} device(s): {devices}',
              file=sys.stderr)
        sys.exit(2)
    print('phase 0: the card', flush=True)
    print(f'  {card_line()}', flush=True)
    print(f'  jax {jax.__version__}; devices {devices}', flush=True)
    for mod in ('pandas', 'h5py'):
        try:
            __import__(mod)
            print(f'  {mod}: present', flush=True)
        except ImportError:
            print(f'  {mod}: absent', flush=True)
    return devices


def phase1(card):
    import jax
    from bench import build_problem
    from picaso_tpu import pipeline

    print('phase 1: production-shape forward', flush=True)
    t0 = time.perf_counter()
    scene, grid, config = build_problem(NWNO)
    jax.block_until_ready(grid.log_kappa)
    print(f'  problem built in {time.perf_counter() - t0:.1f} s', flush=True)
    t0 = time.perf_counter()
    out = jax.block_until_ready(pipeline.forward(scene, grid, config))
    print(f'  forward compile + first call {time.perf_counter() - t0:.1f} s',
          flush=True)
    for k in ('albedo', 'thermal', 'transit_depth'):
        finite(k, out[k], (NWNO,))
    ref = jax.block_until_ready(
        pipeline.forward_reference(scene, grid, config))
    print('  fused Toon kernel vs XLA scan path, both f32, nwno '
          f'{NWNO}:', flush=True)
    for k in ('albedo', 'thermal'):
        check(f'{k} max rel', rel_err(out[k], ref[k])[0], KERNEL_TOL)
    check('transit_depth max rel',
          rel_err(out['transit_depth'], ref['transit_depth'])[0], 1e-6)

    scenes = perturbed(scene, N_TIMED)
    kern = steady_rate(lambda s: pipeline.forward(s, grid, config), scenes)
    xla = steady_rate(lambda s: pipeline.forward_reference(s, grid, config),
                      scenes)
    print(f'  steady state, reflected+thermal+transit: {kern:.1f} spectra/s '
          f'(fused kernel), {xla:.1f} spectra/s (XLA scan path) on {card}',
          flush=True)

    user_api_spectrum()
    return scene, grid, config


def user_api_spectrum():
    """opannection -> inputs -> spectrum on a synthetic 1060-point DB,
    on the GPU and, as the reference, in float64 on the host CPU."""
    import os
    import tempfile
    import jax
    from picaso_tpu import justdoit as jdi
    from picaso_tpu.opacities import factory

    def spectrum(path):
        opa = jdi.opannection(filename_db=path)
        case = jdi.inputs()
        case.phase_angle(0)
        case.gravity(radius=1.0, radius_unit=jdi.u.Unit('Rjup'),
                     mass=1.0, mass_unit=jdi.u.Unit('Mjup'))
        case.star(opa, 5700, 0.0, 4.4, radius=1.0,
                  radius_unit=jdi.u.Unit('Rsun'), semi_major=5.2,
                  semi_major_unit=jdi.u.Unit('au'))
        case.atmosphere(filename=jdi.jupiter_pt(), sep=r'\s+')
        case.clouds(filename=jdi.jupiter_cld(), sep=r'\s+')
        return case.spectrum(opa, calculation='reflected+thermal')

    with tempfile.TemporaryDirectory(dir=os.path.dirname(
            os.path.abspath(__file__))) as tmp:
        path = os.path.join(tmp, 'synthetic.db')
        factory.build_synthetic_db(path, np.linspace(2000.0, 18000.0, 2048),
                                   pt_layout='1060')
        t0 = time.perf_counter()
        df = spectrum(path)
        print(f'  user API spectrum (nwno {len(df["albedo"])}) in '
              f'{time.perf_counter() - t0:.1f} s', flush=True)
        with jax.enable_x64(True), jax.default_device(jax.devices('cpu')[0]):
            df64 = spectrum(path)
    for k in ('albedo', 'thermal'):
        check(f'user API vs CPU float64, {k} max error / peak',
              peak_err(df[k], df64[k]), USER_API_TOL)


def phase2(scene, grid, config):
    import dataclasses
    import jax
    from picaso_tpu import pipeline

    print('phase 2: GPU float32 vs CPU float64', flush=True)
    for label, step, cfg, tol in (
            ('Toon', TOON_CUT, config, TOON_TOL),
            ('SH4', SH_CUT, dataclasses.replace(config, rt_method=1,
                                                stream=4), (SH4_TOL, None))):
        s, g = cut(scene, grid, step)
        nw = int(g.wno.shape[0])
        gpu = jax.tree_util.tree_map(
            np.asarray, pipeline.forward(s, g, cfg))
        t0 = time.perf_counter()
        cpu = on_cpu64(lambda s, g: pipeline.forward(s, g, cfg), s, g)
        print(f'  {label}, nwno {nw} (CPU float64 path '
              f'{time.perf_counter() - t0:.1f} s):', flush=True)
        keys = ('albedo', 'thermal') + (('transit_depth',)
                                        if label == 'Toon' else ())
        for k in keys:
            mx, med = rel_err(gpu[k], cpu[k])
            check(f'{label} {k} max rel', mx, tol[0])
            if tol[1] is not None:
                check(f'{label} {k} median rel', med, tol[1])


def phase3(scene, grid, config):
    import jax
    import jax.numpy as jnp
    from picaso_tpu import pipeline

    print('phase 3: batched forward and likelihood', flush=True)
    nb = 8
    scenes = perturbed(scene, 3 * nb)
    batches = [pipeline.stack_scenes(scenes[i * nb:(i + 1) * nb])
               for i in range(3)]
    t0 = time.perf_counter()
    out = jax.block_until_ready(
        pipeline.forward_batch(batches[0], grid, config))
    print(f'  forward_batch compile + first call '
          f'{time.perf_counter() - t0:.1f} s', flush=True)
    for k in ('albedo', 'thermal', 'transit_depth'):
        finite(k, out[k], (nb, NWNO))
    one = pipeline.forward(scenes[nb - 1], grid, config)
    for k in ('albedo', 'thermal'):
        check(f'batch member {nb - 1} vs single forward, {k} max rel',
              rel_err(out[k][nb - 1], one[k])[0], 1e-5)

    y = out['albedo'][0]

    @jax.jit
    def chi2(alb, y):
        return -0.5 * jnp.sum((alb - y[None]) ** 2, axis=-1) / 1e-6

    def loglike(b):
        return chi2(pipeline.forward_batch(b, grid, config)['albedo'], y)

    ll = np.asarray(loglike(batches[0]))
    finite('loglike', ll, (nb,))
    check('loglike of the data scene', abs(float(ll[0])), 1e-6)
    if not (ll[1:] < 0).all():
        raise SmokeFailure(f'perturbed scenes must fit worse: {ll}')
    rate = steady_rate(loglike, [batches[0]] + batches[1:] * N_TIMED)
    print(f'  {rate * nb:.1f} likelihoods/s (batch {nb})', flush=True)


def solve_rce(ck, nlevel=91, **kw):
    from bench import brown_dwarf_case
    from picaso_tpu import justdoit as jdi
    t0 = time.perf_counter()
    opa = jdi.opannection(ck_table=ck, method='preweighted')
    out = brown_dwarf_case(nlevel=nlevel).climate(opa, verbose=False, **kw)
    if not out['converged']:
        raise SmokeFailure('RCE solve did not converge')
    t = np.asarray(out['temperature'], np.float64)
    finite('temperature', t, (nlevel,))
    return t, time.perf_counter() - t0


def phase4():
    from concurrent.futures import ThreadPoolExecutor
    import jax
    from picaso_tpu.opacities.ck import synthetic_ck_table

    def cpu_solve():
        with jax.default_device(jax.devices('cpu')[0]):
            return solve_rce(synthetic_ck_table())

    print('phase 4: 91-level RCE solve (float64, case.climate)', flush=True)
    # the CPU reference runs beside the GPU solve, in a thread of its own
    with ThreadPoolExecutor(1) as pool:
        cpu = pool.submit(cpu_solve)
        t_gpu, s_gpu = solve_rce(synthetic_ck_table())
        print(f'  GPU solve converged in {s_gpu:.1f} s', flush=True)
        t_cpu, s_cpu = cpu.result()
    print(f'  CPU solve converged in {s_cpu:.1f} s', flush=True)
    check('max |T_gpu - T_cpu| (K)', float(np.abs(t_gpu - t_cpu).max()),
          CLIMATE_TOL_K)


def four_cards(devices):
    import jax
    import jax.numpy as jnp
    from bench import build_problem, ck_wavelength_slice
    from picaso_tpu import parallel, pipeline
    from picaso_tpu.opacities.ck import synthetic_ck_table

    print('four cards: (batch, wave) mesh', flush=True)
    mesh = parallel.make_mesh(n_wave=2, n_batch=2, devices=devices[:4])
    print(f'  mesh {dict(mesh.shape)} over {devices[:4]}', flush=True)
    scene, grid, config = build_problem(NWNO)
    nb = 4
    batch = pipeline.stack_scenes(perturbed(scene, nb)[:nb])
    batch_s = parallel.shard_scene(batch, mesh, batched=True)
    grid_s = parallel.shard_grid(grid, mesh)
    for name, x in (('grid.log_kappa', grid_s.log_kappa),
                    ('batch.cld_opd', batch_s.cld_opd),
                    ('batch.tlevel', batch_s.tlevel)):
        print(f'  {name}: {x.sharding.spec}, on '
              f'{sorted(d.id for d in x.sharding.device_set)}', flush=True)
    t0 = time.perf_counter()
    out = jax.block_until_ready(parallel.sharded_forward(
        batch_s, grid_s, config, mesh, batched=True))
    print(f'  sharded forward compile + first call '
          f'{time.perf_counter() - t0:.1f} s', flush=True)
    for k, v in out.items():
        print(f'  out {k}: {v.sharding.spec}, on '
              f'{sorted(d.id for d in v.sharding.device_set)}', flush=True)
        finite(k, v, (nb, NWNO))
    one = {k: np.asarray(v) for k, v in pipeline.forward_batch(
        jax.device_put(batch, devices[0]), jax.device_put(grid, devices[0]),
        config).items()}
    for k in out:
        check(f'sharded vs one card, {k} max rel',
              rel_err(out[k], one[k])[0], 1e-5)

    y = jax.device_put(one['albedo'][0], jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec('wave')))

    @jax.jit
    def chi2(alb, y):
        return -0.5 * jnp.sum((alb - y[None]) ** 2, axis=-1) / 1e-6

    ll = np.asarray(chi2(out['albedo'], y))
    ll_one = np.asarray(chi2(jnp.asarray(one['albedo']),
                             jnp.asarray(one['albedo'][0])))
    print(f'  loglike sharded {ll}, one card {ll_one}', flush=True)
    check('sharded vs one card, loglike max abs diff',
          float(np.abs(ll - ll_one).max()), 1e-3 * max(1.0, np.abs(
              ll_one).max()))
    rates = []
    for _ in range(3):
        t0 = time.perf_counter()
        for i in range(N_TIMED):
            b = batch_s._replace(tlevel=batch_s.tlevel * (1 + 1e-4 * i),
                                 tlayer=batch_s.tlayer * (1 + 1e-4 * i))
            o = parallel.sharded_forward(b, grid_s, config, mesh,
                                         batched=True)
        jax.block_until_ready(o)
        rates.append(N_TIMED * nb / (time.perf_counter() - t0))
    print(f'  sharded forward, 4 cards: {np.median(rates):.1f} spectra/s',
          flush=True)

    # the mesh climate: 41 levels on a 48-bin slice of the table (the
    # multi-device rehearsal's problem), one card against the mesh
    ck = ck_wavelength_slice(synthetic_ck_table(), stride=4, multiple=16)
    t_one, s_one = solve_rce(ck, nlevel=41)
    print(f'  RCE (41 levels, 48 bins) on one card converged in '
          f'{s_one:.1f} s', flush=True)
    t_mesh, s_mesh = solve_rce(ck, nlevel=41,
                               mesh=parallel.make_mesh(
                                   n_wave=4, devices=devices[:4]))
    print(f'  RCE on the wave-sharded mesh converged in {s_mesh:.1f} s',
          flush=True)
    check('max |T_mesh - T_one| (K)', float(np.abs(t_mesh - t_one).max()),
          MESH_CLIMATE_TOL_K)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--four-cards', action='store_true',
                        help='run only the four-GPU mesh path')
    args = parser.parse_args(argv)
    devices = phase0(4 if args.four_cards else 1)
    card = card_line()
    try:
        if args.four_cards:
            four_cards(devices)
        else:
            scene, grid, config = phase1(card)
            phase2(scene, grid, config)
            phase3(scene, grid, config)
            del scene, grid
            phase4()
    except SmokeFailure as e:
        print(f'FAILED: {e}', file=sys.stderr, flush=True)
        return 1
    d = devices[0]
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': d.platform, 'kind': d.device_kind,
        'count': len(devices)}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
