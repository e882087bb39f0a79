"""Re-measure the round-invariant bench baselines into bench_cache.json.

Run from the repo root: ``python scripts/refresh_bench_cache.py``.
Measures (1) the ACTUAL reference implementation's spectra/s (pure numpy
via the numba shim, wavelength slice scaled to the production grid) and
(2) this framework's own forward on one CPU host — both in clean
JAX_PLATFORMS=cpu subprocesses, no accelerator needed.  bench.py reads the file
instead of paying these ~1-5 minute subprocesses inside the bench
window; refresh whenever the forward program changes materially
(PICASO_BENCH_REFRESH=1 makes bench.py ignore the cache).
"""
import datetime
import json
import os
import subprocess
import sys

here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, here)
os.chdir(here)
import bench  # noqa: E402

out = {}
print('measuring reference numpy rate...', flush=True)
out['reference_numpy_spectra_per_s'] = bench._reference_numpy_subprocess()
print('  ->', out['reference_numpy_spectra_per_s'], flush=True)
print('measuring XLA-CPU baseline...', flush=True)
out['cpu_rate_full'] = bench._cpu_baseline_subprocess()
print('  ->', out['cpu_rate_full'], flush=True)
try:
    out['commit'] = subprocess.run(
        ['git', 'rev-parse', '--short', 'HEAD'], capture_output=True,
        text=True, cwd=here).stdout.strip()
except Exception:
    out['commit'] = 'unknown'
out['date'] = datetime.date.today().isoformat()
with open(os.path.join(here, 'bench_cache.json'), 'w') as f:
    json.dump(out, f, indent=1)
print(json.dumps(out))
