"""Benchmarks for every BASELINE.md config, at production workload shapes.

Headline metric (the printed JSON line's value): full-resolution 1D
reflected+thermal spectrum rate at the PRODUCTION opacity-table shape —
the ragged 1060-point (T, P) grid of the real monochromatic DBs, 16
molecules, nwno = 50,000 (R~15k window), 90 layers, 2 CIA continua,
Rayleigh, cloudy, 10 half-sphere Gauss disk angles.  The opacity cube is
synthetic-valued but production-SIZED (16 x 1060 x 50k f32 = 3.4 GB in
device memory), so memory pressure, the ragged index math, and molecule
count match the real workload.  Steady-state rate, temperatures
perturbed every call.

The other BASELINE configs ride in the same JSON line under "extra":
  - climate_s / climate_661_s / climate_cloudy_s / climate_diseq_s: the
    four production climate modes (chemeq 196-bin legacy EGP, 661-bin
    grid, virga-coupled cloudy, disequilibrium resort-rebin+quench),
    solved one after another in this process.  Per-mode time covers
    opannection + setup + the full RCE solve.
  - sh4_spectra_per_s / sh4_fullres_spectra_per_s: SH 4-stream
    reflected+thermal rate, native f32 (rt/sh.py incoming grouping) at
    nwno=2000 and the full 5e4 grid; sh4_phase_curve_points_per_s is
    BASELINE config #4 (3D disco-ball phase curve through SH4, one
    batched dispatch).
  - likelihoods_per_s: batched forward + chi^2 (the retrieval
    nested-sampling inner loop) at production shape.
  - gather_stage_ms: the opacity gather (pipeline.gather_taugas) timed
    on its own.
  - transit_spectra_per_s: full-res transmission rate.
  - vs_reference_numpy: measured rate of the ACTUAL reference
    implementation (numba shimmed to pure numpy — numba isn't installed
    here; note compiled numba would be faster than this numpy figure) on
    the same physics at a wavelength slice, scaled linearly in nwno.
    Cached in bench_cache.json (the reference's rate doesn't change
    round to round) — refresh with PICASO_BENCH_REFRESH=1.
  - vs_baseline (top-level): ratio against this same XLA program on one
    CPU host — a conservative lower bound (XLA-CPU already beats the
    reference's loops).  Also cached.
  - device: the JAX platform, device kind and count, and the card's
    name and power limit from nvidia-smi.

Every measurement runs in this one process, which holds the device;
subprocesses (the cached CPU baselines) run on the host CPU only.

Budget discipline: PICASO_BENCH_BUDGET_S (default 750 s) is a hard
deadline.  After every stage the would-be-final JSON is written to
BENCH_PARTIAL.json; a stage only starts if its estimated cost fits the
remaining budget (skips are recorded in extra.skipped); SIGTERM/SIGINT
print the final line from whatever has been gathered.  Stdout carries
ONLY the final JSON line.

Prints exactly one JSON line.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np

_T0 = time.perf_counter()
_BUDGET_S = float(os.environ.get('PICASO_BENCH_BUDGET_S', 750))
_HERE = os.path.dirname(os.path.abspath(__file__))


def _mark(msg):
    """Stage progress on stderr (stdout carries ONLY the JSON line)."""
    print(f'[bench +{time.perf_counter() - _T0:7.1f}s] {msg}',
          file=sys.stderr, flush=True)


def _remaining():
    return _BUDGET_S - (time.perf_counter() - _T0)


NWNO = 50_000
NLEVEL = 91
N_ITER = 30

MOLECULES_16 = ('H2O', 'CH4', 'CO', 'NH3', 'CO2', 'H2S', 'TiO', 'VO',
                'Na', 'K', 'FeH', 'C2H2', 'HCN', 'PH3', 'SO2', 'CrH')
MIX_16 = {'H2O': 1e-3, 'CH4': 5e-4, 'CO': 3e-4, 'NH3': 1e-4, 'CO2': 1e-5,
          'H2S': 3e-5, 'TiO': 1e-7, 'VO': 1e-8, 'Na': 1e-6, 'K': 1e-7,
          'FeH': 1e-8, 'C2H2': 1e-7, 'HCN': 1e-7, 'PH3': 1e-6,
          'SO2': 1e-8, 'CrH': 1e-9}


def build_problem(nwno, dtype=np.float32, nlevel=NLEVEL, production=True):
    """Scene + grid + config at the requested size.

    production=True uses the ragged 1060-point PT grid with 16 molecules
    (the real table shape); False keeps a small regular grid (used by
    tests for quick iteration).
    """
    from picaso_tpu.opacities import factory
    from picaso_tpu import pipeline

    wno = np.linspace(300.0, 33000.0, nwno)  # ~0.3-33 um
    if production:
        grid = factory.synthetic_opacity_grid_ragged(
            wno, molecules=MOLECULES_16, dtype=dtype)
        mix_vals = MIX_16
    else:
        grid = factory.synthetic_opacity_grid(
            wno, molecules=('H2O', 'CH4', 'CO', 'NH3', 'CO2', 'H2S'),
            ntemp=15, npress=10, dtype=dtype)
        mix_vals = {m: MIX_16[m] for m in grid.molecules}
    pressure = np.logspace(-6, 2.5, nlevel)
    temperature = np.clip(1200.0 * (pressure / 50.0) ** 0.08, 150.0, None)
    mix = {'H2': np.zeros(nlevel) + 0.84, 'He': np.zeros(nlevel) + 0.155}
    for m, v in mix_vals.items():
        mix[m] = np.zeros(nlevel) + v
    nlayer = nlevel - 1
    cld = {'opd': np.repeat(np.linspace(0.0, 1.0, nlayer) ** 2, nwno),
           'g0': np.zeros(nlayer * nwno) + 0.85,
           'w0': np.zeros(nlayer * nwno) + 0.95}
    scene, config = pipeline.scene_from_arrays(
        pressure, temperature, mix, grid, gravity=2500.0,
        radius=7.1492e9, mass=1.898e30, cld=cld, rstar=6.96e10,
        dtype=dtype)
    return scene, grid, config


def _rate(fn, scenes, n_iter, n_pass=3):
    """Best-of-n_pass rate: the standard min-time estimator for a
    deterministic device-bound workload."""
    import jax
    out = fn(scenes[0])
    jax.block_until_ready(out)
    best = float('inf')
    for _ in range(n_pass):
        t0 = time.perf_counter()
        for s in scenes[1:n_iter + 1]:
            out = fn(s)
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    return n_iter / best


def _perturbed(scene, n):
    return [scene._replace(tlevel=scene.tlevel * (1 + 0.001 * i),
                           tlayer=scene.tlayer * (1 + 0.001 * i))
            for i in range(n + 1)]


def measure(nwno, n_iter, dtype=np.float32, production=True,
            config_patch=None):
    from picaso_tpu import pipeline

    scene, grid, config = build_problem(nwno, dtype, production=production)
    if config_patch:
        config = dataclasses.replace(config, **config_patch)
    scenes = _perturbed(scene, n_iter)
    return _rate(lambda s: pipeline.forward(s, grid, config), scenes,
                 n_iter)


def _gather_ms(grid, config, scenes):
    """The opacity gather stage alone (pipeline.gather_taugas)."""
    import jax
    from picaso_tpu import pipeline

    n = min(len(scenes) - 1, 20)
    gather = jax.jit(pipeline.gather_taugas, static_argnames=('config',))
    jax.block_until_ready(gather(scenes[0], grid, config))
    best = float('inf')
    for _ in range(3):
        t0 = time.perf_counter()
        for s in scenes[1:n + 1]:
            out = gather(s, grid, config)
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    return 1e3 * best / n


def measure_spectra_and_transit(nwno, n_iter, extra):
    # headline + transit rates from ONE production problem: the 3.4 GB
    # table is built once
    from picaso_tpu import pipeline

    scene, grid, config = build_problem(nwno)
    scenes = _perturbed(scene, n_iter)
    headline = _rate(lambda s: pipeline.forward(s, grid, config), scenes,
                     n_iter)
    _mark(f'headline rate {headline:.1f}/s; gather stage')
    stages = {'gather_stage_ms': round(_gather_ms(grid, config, scenes),
                                       3)}
    _mark('transit')
    cfg_t = dataclasses.replace(config, reflected=False, thermal=False,
                                transmission=True)
    transit = _rate(lambda s: pipeline.forward(s, grid, cfg_t), scenes,
                    n_iter)
    # batched-retrieval configuration: 8 scenes through forward_batch =
    # ONE dispatch (the production likelihood path; the reference farms
    # these to MPI ranks).  Rate is per-spectrum.  Isolated try: a
    # failure here must not discard the already-measured headline.
    import jax
    import jax.numpy as jnp
    _mark('batched + likelihood')
    try:
        nb = 8
        n_rep = 20
        batches = [pipeline.stack_scenes(scenes[i * nb:(i + 1) * nb])
                   for i in range(max(1, (n_iter + 1) // nb))]
        out = pipeline.forward_batch(batches[0], grid, config)
        jax.block_until_ready(out)
        best = float('inf')
        for _ in range(3):
            t0 = time.perf_counter()
            for i in range(n_rep):
                out = pipeline.forward_batch(batches[i % len(batches)],
                                             grid, config)
            jax.block_until_ready(out)
            best = min(best, time.perf_counter() - t0)
        stages['batched8_spectra_per_s'] = round(n_rep * nb / best, 2)

        # retrieval-likelihood rate: batched forward + chi^2 against a
        # data vector, ONE scalar logL per scene — the production
        # nested-sampling inner loop (replaces the MPI pool, reference
        # driver.py:406-427).  The chi^2 is its own tiny jit on the
        # forward_batch outputs, so the production-shape program is not
        # compiled a second time.
        y = out['albedo'][0] if isinstance(out, dict) else None

        @jax.jit
        def chi2(alb, y):
            return -0.5 * jnp.sum((alb - y[None]) ** 2, axis=-1)

        def loglike(b, y):
            return chi2(pipeline.forward_batch(b, grid, config)['albedo'],
                        y)

        ll = loglike(batches[0], y)
        jax.block_until_ready(ll)
        best = float('inf')
        for _ in range(3):
            t0 = time.perf_counter()
            for i in range(n_rep):
                ll = loglike(batches[i % len(batches)], y)
            jax.block_until_ready(ll)
            best = min(best, time.perf_counter() - t0)
        stages['likelihoods_per_s'] = round(n_rep * nb / best, 2)
        batches = out = ll = None
    except Exception as e:
        stages['batched8_error'] = f'{type(e).__name__}: {e}'[:160]
    return headline, transit, stages


# the four production climate modes (reference climate.py:2842-3124):
# chemeq on both production grids (196-bin legacy EGP and 661-bin,
# optics.py:1390-1395), cloudy (virga microphysics in the loop), and
# diseq (MLT kzz + Zahnle-Marley quench, per-gas resort-rebin tables).
CLIMATE_MODES = [
    ('chemeq', {}, 700.0, None, {}),
    ('661', {'grid661': True}, 700.0, None, {}),
    ('cloudy', {}, 400.0, 'cloudy', {}),
    ('diseq', {'with_per_gas': True}, 700.0, 'quench',
     {'diseq_chem': True}),
]


def brown_dwarf_case(teff=700.0, nlevel=NLEVEL):
    """The brown-dwarf RCE case the climate modes solve: g = 100 m/s^2,
    a power-law guess on log-spaced levels from 1e-4 to 10^2.5 bar."""
    from picaso_tpu import justdoit as jdi

    case = jdi.inputs(calculation='brown')
    case.phase_angle(0)
    case.gravity(gravity=100.0, gravity_unit=jdi.u.Unit('m/(s**2)'))
    case.effective_temp(teff)
    case.setup_nostar()
    case.setup_climate()
    pressure = np.logspace(-4, 2.5, nlevel)
    guess = np.clip(teff * (pressure / 10.0) ** 0.12, 250.0, 2800.0)
    case.inputs_climate(temp_guess=guess, pressure=pressure,
                        rcb_guess=nlevel - 20 if nlevel > 60 else nlevel - 8,
                        rfacv=0.0)
    return case


def ck_wavelength_slice(ck, stride, multiple):
    """Every ``stride``-th bin of a CK table, cut to a whole number of
    ``multiple`` bins first (so it shards evenly over a mesh)."""
    from picaso_tpu.opacities.ck import CKTable

    a = ck.arrays
    nbin = len(np.asarray(a.wno))
    sl = np.s_[:(nbin // multiple) * multiple:stride]
    return CKTable(
        a._replace(wno=a.wno[sl], delta_wno=a.delta_wno[sl],
                   ln_kappa=a.ln_kappa[:, :, sl, :],
                   cont_opa=a.cont_opa[:, :, sl]),
        ck.molecules, ck.full_abunds, ck.gauss_pts, ck.temps,
        ck.pressures, wno=ck.wno[sl], delta_wno=ck.delta_wno[sl],
        gauss_wts=ck.gauss_wts)


def run_climate_mode(ck_kwargs, teff, extra, climate_kwargs, nlevel=NLEVEL):
    """One brown-dwarf RCE solve; returns (seconds, converged)."""
    from picaso_tpu import justdoit as jdi
    from picaso_tpu.opacities.ck import synthetic_ck_table

    t0 = time.perf_counter()
    opa_ck = jdi.opannection(ck_table=synthetic_ck_table(**ck_kwargs),
                             method='preweighted')
    case = brown_dwarf_case(teff, nlevel)
    if extra == 'cloudy':
        case.inputs['climate']['cloudy'] = True
        case.inputs['climate']['virga_kwargs'] = {
            'condensates': ['H2O'], 'fsed': 3.0, 'mh': 1.0, 'mmw': 2.2}
    elif extra == 'quench':
        case.inputs['approx']['chem_params']['quench'] = True
    out = case.climate(opa_ck, verbose=False, **climate_kwargs)
    return time.perf_counter() - t0, bool(out['converged'])


def measure_climate_all(extra):
    """All four climate modes, one after another in this process.

    Per-mode time = opannection + setup + full RCE solve, compilation
    included (a warm persistent compile cache shortens it)."""
    est = 150.0   # first-mode estimate; later modes use observed times
    for name, ck_kwargs, teff, kind, ckw in CLIMATE_MODES:
        key = 'climate' if name == 'chemeq' else f'climate_{name}'
        if _remaining() < 0.8 * est + 15:
            extra.setdefault('skipped', []).append(key)
            continue
        _mark(f'climate mode {name}')
        try:
            s, conv = run_climate_mode(ck_kwargs, teff, kind, ckw)
            est = max(60.0, s)
            extra[f'{key}_s'] = round(s, 2)
            extra[f'{key}_converged'] = conv
        except Exception as e:
            extra[f'{key}_error'] = f'{type(e).__name__}: {e}'[:200]
        _emit_partial()


def measure_sh(nwno=2000, n_iter=20, production=False, streams=(4, 2)):
    """SH 2/4-stream reflected+thermal rates, in this process.

    Runs the native f32 path (rt/sh.py precision='auto': incoming-field
    block-row pairing + expm1-hardened sources; ~2e-3 max relative
    error vs the f64 oracle) — no x64 subprocess, no global flag flip.
    """
    from picaso_tpu import pipeline

    scene, grid, config = build_problem(nwno, production=production)
    out = {}
    for stream in streams:
        cfg = dataclasses.replace(config, rt_method=1, stream=stream)
        scenes = _perturbed(scene, n_iter)
        out[f'sh{stream}_rate'] = _rate(
            lambda s: pipeline.forward(s, grid, cfg), scenes, n_iter)
    return out


def measure_sh4_phase_curve(nwno=2000, n_phase=4, n_iter=10):
    """BASELINE config #4: SH4 reflected+thermal 3D phase curve.

    One batched dispatch computes every phase point of the disco ball
    (Gauss x Chebyshev 6x6 disk, geometry varying per phase) through the
    SH 4-stream solver — the single-program replacement for the
    reference's joblib fan-out (justdoit.py:4741-4777 with rt_method
    'SH', fluxes.py:2675/2979).  Reported as phase-points (full
    reflected+thermal disco spectra) per second.
    """
    import jax
    from picaso_tpu import disco as disco_mod
    from picaso_tpu import pipeline

    scene, grid, config = build_problem(nwno, production=False)
    cfg = dataclasses.replace(config, rt_method=1, stream=4)
    phases = np.linspace(0.0, 2 * np.pi, n_phase, endpoint=False)
    dtype = np.asarray(scene.cld_opd).dtype
    phase_scenes = []
    for i, p in enumerate(phases):
        g = disco_mod.make_geometry(float(p), num_gangle=6, num_tangle=6)
        phase_scenes.append(scene._replace(
            ubar0=np.asarray(g.ubar0, dtype),
            ubar1=np.asarray(g.ubar1, dtype),
            gweight=np.asarray(g.gweight, dtype),
            tweight=np.asarray(g.tweight, dtype),
            cos_theta=np.asarray(g.cos_theta, dtype),
            tlevel=scene.tlevel * (1 + 0.001 * i),
            tlayer=scene.tlayer * (1 + 0.001 * i)))
    batch = pipeline.stack_scenes(phase_scenes)
    out = pipeline.forward_batch(batch, grid, cfg)
    jax.block_until_ready(out)
    best = float('inf')
    for _ in range(3):
        t0 = time.perf_counter()
        for i in range(n_iter):
            b = batch._replace(tlevel=batch.tlevel * (1 + 1e-4 * i),
                               tlayer=batch.tlayer * (1 + 1e-4 * i))
            out = pipeline.forward_batch(b, grid, cfg)
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    return n_iter * n_phase / best


def _reference_numpy_subprocess():
    """Time the actual reference (pure numpy via the numba shim) on the
    same physics at a wavelength slice; returns spectra/s scaled to NWNO."""
    code = r'''
import json, sys, time
import numpy as np
sys.path.insert(0, 'tests')
import refshim
jdi_ref = refshim.load_reference('justdoit')
from picaso_tpu.opacities import factory
nwno = 2000
wno = np.linspace(300.0, 33000.0, nwno)
db = '/tmp/bench_ref_syn.db'
import os
if not os.path.exists(db):
    factory.build_synthetic_db(db, wno,
        molecules=('H2O','CH4','CO','NH3','CO2','H2S'), ntemp=10, npress=8)
opa = jdi_ref.opannection(filename_db=db)
opa.get_opacities = type(opa).get_opacities.__get__(opa)
case = jdi_ref.inputs()
case.phase_angle(0, num_gangle=10, num_tangle=1)
case.gravity(gravity=25, gravity_unit=jdi_ref.u.Unit('m/(s**2)'))
case.setup_nostar()
case.atmosphere(filename=jdi_ref.jupiter_pt(), sep=r'\s+')
case.approx(raman='none')
case.spectrum(opa, calculation='thermal')       # warm caches
n = 3
t0 = time.perf_counter()
for i in range(n):
    case.spectrum(opa, calculation='reflected+thermal')
dt = (time.perf_counter() - t0) / n
print(json.dumps({"ref_rate_at_slice": 1.0/dt, "nwno": nwno}))
'''
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    res = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=1800, env=env, cwd=_HERE)
    d = json.loads(res.stdout.strip().splitlines()[-1])
    # reference cost is linear in nwno (per-wavelength loops)
    return d['ref_rate_at_slice'] * d['nwno'] / NWNO


def _cpu_baseline_subprocess():
    """This same XLA program on one CPU host, in a clean subprocess."""
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    res = subprocess.run(
        [sys.executable, os.path.abspath(__file__), '--cpu-baseline'],
        capture_output=True, text=True, timeout=1800, env=env, cwd=_HERE)
    return json.loads(res.stdout.strip().splitlines()[-1])['cpu_rate_full']


def _load_baseline_cache():
    """reference-numpy + XLA-CPU rates from bench_cache.json.

    Neither changes round to round (the reference is frozen; the CPU
    baseline only moves when the forward program changes materially), so
    they are measured once, stamped with the commit, and reused — two
    ~1-5 minute subprocesses the bench window doesn't have to pay.
    Refresh with PICASO_BENCH_REFRESH=1 or scripts/refresh_bench_cache.py.
    """
    if os.environ.get('PICASO_BENCH_REFRESH') == '1':
        return None
    try:
        with open(os.path.join(_HERE, 'bench_cache.json')) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


# ---------------------------------------------------------------------------
# incremental emission + deadline plumbing
# ---------------------------------------------------------------------------

_RESULT = {'metric': None, 'value': None, 'unit': 'spectra/s',
           'vs_baseline': None, 'extra': {}}
_PRINTED = [False]


def _emit_partial():
    try:
        with open(os.path.join(_HERE, 'BENCH_PARTIAL.json'), 'w') as f:
            json.dump(_RESULT, f)
    except OSError:
        pass


_EMIT_LOCK = threading.Lock()


def _emit_final():
    # single-print guard must be atomic once the watchdog thread exists
    with _EMIT_LOCK:
        if _PRINTED[0]:
            return
        _PRINTED[0] = True
    _RESULT['extra']['bench_elapsed_s'] = round(
        time.perf_counter() - _T0, 1)
    print(json.dumps(_RESULT), flush=True)


def _on_signal(signum, frame):
    _RESULT['extra']['terminated_by'] = signal.Signals(signum).name
    _emit_final()
    os._exit(0)


def _start_watchdog():
    """Print the final JSON at the deadline even if the main thread is
    wedged inside a C call.

    Python signal handlers only run between bytecodes; an XLA compile
    that hangs keeps the main thread inside a C extension, so SIGTERM
    from an outer `timeout` never reaches _on_signal.  A daemon thread
    needs only the GIL (XLA compiles release it): it emits whatever has
    been gathered and exits 0.
    """
    def _watch():
        grace = 15.0  # let a final in-flight stage record first
        while True:
            left = _BUDGET_S + grace - (time.perf_counter() - _T0)
            if left <= 0:
                break
            time.sleep(min(left, 5.0))
        _RESULT['extra']['terminated_by'] = 'watchdog'
        _emit_final()
        sys.stdout.flush()
        os._exit(0)

    threading.Thread(target=_watch, daemon=True).start()


def _device_info():
    """The device the numbers were taken on: JAX's view and the card's
    name and power limit (nvidia-smi), which bound its clocks."""
    import jax
    d = jax.devices()[0]
    info = {'platform': d.platform, 'kind': d.device_kind,
            'count': len(jax.devices()), 'card': None}
    try:
        info['card'] = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        pass
    return info


def main():
    if '--cpu-baseline' in sys.argv:
        os.environ['JAX_PLATFORMS'] = 'cpu'
        import jax
        jax.config.update('jax_platforms', 'cpu')
        nwno_cpu = 5_000
        rate = measure(nwno_cpu, 5, production=False)
        print(json.dumps({'cpu_rate_full': rate * nwno_cpu / NWNO}))
        return

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    _start_watchdog()

    import gc

    import jax
    extra = _RESULT['extra']
    extra['device'] = _device_info()
    rate = None
    _mark('headline: build + measure')
    try:
        rate, transit_rate, stages = measure_spectra_and_transit(
            NWNO, N_ITER, extra)
        extra['transit_spectra_per_s'] = round(transit_rate, 2)
        extra.update(stages)
    except Exception as e:
        extra['headline_error'] = f'{type(e).__name__}: {e}'[:200]

    platform = extra['device']['platform']
    _RESULT['metric'] = (
        '1D reflected+thermal spectra/sec at production table shape '
        f'(1060-pt ragged PT grid, 16 molecules, nwno={NWNO}, '
        f'nlevel={NLEVEL}, {platform})')
    _RESULT['value'] = round(rate, 4) if rate is not None else None
    _emit_partial()

    # cached baselines first: free, and they complete the vs_* story
    # even if a later stage eats the budget
    cache = _load_baseline_cache()
    if cache and rate is not None:
        ref_rate = cache.get('reference_numpy_spectra_per_s')
        cpu_rate = cache.get('cpu_rate_full')
        extra['baseline_cache'] = {
            k: cache.get(k) for k in ('commit', 'date')}
        if ref_rate:
            extra['reference_numpy_spectra_per_s'] = round(ref_rate, 5)
            extra['vs_reference_numpy'] = round(rate / ref_rate, 1)
            # numba is not installable in this image, so the BASELINE
            # ">50x vs numba-CPU" target is checked by inference:
            # published numba-vs-numpy speedups for loop-heavy float
            # kernels of this shape are 10-30x, so a compiled reference
            # would run at most ~30x the measured numpy rate.
            extra['reference_numba_estimated'] = round(ref_rate * 30.0, 4)
            extra['vs_reference_numba_floor'] = round(
                rate / (ref_rate * 30.0), 1)
        if cpu_rate:
            _RESULT['vs_baseline'] = round(rate / cpu_rate, 2)
    _emit_partial()

    # release the 3.4 GB device table before the next configurations
    gc.collect()
    jax.clear_caches()
    gc.collect()

    # SH native f32 in-process, at the SH-bench slice AND full resolution
    if _remaining() > 90:
        _mark('SH native f32 (nwno=2000)')
        try:
            sh = measure_sh(nwno=2000)
            extra['sh4_spectra_per_s'] = round(sh['sh4_rate'], 3)
            extra['sh2_spectra_per_s'] = round(sh['sh2_rate'], 3)
            _mark('SH full-res')
            sh_full = measure_sh(nwno=NWNO, n_iter=8, streams=(4, 2))
            extra['sh4_fullres_spectra_per_s'] = round(
                sh_full['sh4_rate'], 3)
            extra['sh2_fullres_spectra_per_s'] = round(
                sh_full['sh2_rate'], 3)
            extra['sh_note'] = ('native f32 in-process, XLA block-Thomas '
                                f'scan (rt/sh.py); nwno=2000 and full-res '
                                f'nwno={NWNO}, reflected+thermal')
        except Exception as e:
            extra['sh4_error'] = f'{type(e).__name__}: {e}'[:200]
            jax.clear_caches()
    else:
        extra.setdefault('skipped', []).append('sh')
    _emit_partial()
    if _remaining() > 45:
        _mark('SH4 3D phase curve')
        try:
            extra['sh4_phase_curve_points_per_s'] = round(
                measure_sh4_phase_curve(), 3)
            extra['sh4_phase_curve_note'] = (
                'BASELINE config #4: 4-phase 3D disco ball (6x6 '
                'gauss-cheby facets), SH4 reflected+thermal, one batched '
                'dispatch, nwno=2000')
        except Exception as e:
            extra['sh4_phase_curve_error'] = f'{type(e).__name__}: {e}'[:200]
            jax.clear_caches()
    else:
        extra.setdefault('skipped', []).append('sh4_phase_curve')
    _emit_partial()
    gc.collect()
    jax.clear_caches()
    gc.collect()

    # all four climate modes, in this process, deadline-aware
    if _remaining() > 90:
        _mark('climate (all modes)')
        measure_climate_all(extra)
    else:
        extra.setdefault('skipped', []).append('climate')
    _emit_partial()

    # baselines not cached: measure only with time to spare
    if cache is None and rate is not None:
        if _remaining() > 120:
            _mark('reference numpy subprocess')
            try:
                ref_rate = _reference_numpy_subprocess()
                extra['reference_numpy_spectra_per_s'] = round(ref_rate, 5)
                extra['vs_reference_numpy'] = round(rate / ref_rate, 1)
                extra['reference_numba_estimated'] = round(
                    ref_rate * 30.0, 4)
                extra['vs_reference_numba_floor'] = round(
                    rate / (ref_rate * 30.0), 1)
            except Exception as e:
                extra['reference_error'] = f'{type(e).__name__}: {e}'[:200]
        else:
            extra.setdefault('skipped', []).append('reference_numpy')
        if _remaining() > 120:
            _mark('cpu baseline subprocess')
            try:
                _RESULT['vs_baseline'] = round(
                    rate / _cpu_baseline_subprocess(), 2)
            except Exception:
                pass
        else:
            extra.setdefault('skipped', []).append('cpu_baseline')

    _emit_final()


if __name__ == '__main__':
    main()
