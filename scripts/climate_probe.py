"""Timed verbose probe of one climate mode (diagnosis).

Usage: python scripts/climate_probe.py [mode]   # chemeq|661|cloudy|diseq
Prints per-iteration progress with wall-clock stamps.
"""
import sys
import time

sys.path.insert(0, '.')

import numpy as np
import jax, jax.numpy as jnp

np.asarray(jnp.zeros(1))
t0 = time.perf_counter()


class _Stamp:
    def __init__(self, stream):
        self.stream = stream

    def write(self, s):
        if s.strip():
            self.stream.write(f'[+{time.perf_counter() - t0:7.1f}s] ')
        self.stream.write(s)
        self.stream.flush()

    def flush(self):
        self.stream.flush()


sys.stdout = _Stamp(sys.__stdout__)

from picaso_tpu import justdoit as jdi
from picaso_tpu.opacities.ck import synthetic_ck_table

mode = sys.argv[1] if len(sys.argv) > 1 else '661'
ck_kwargs = {}
teff = 700.0
climate_kwargs = {}
if mode == '661':
    ck_kwargs['grid661'] = True
elif mode == 'diseq':
    ck_kwargs['with_per_gas'] = True
    climate_kwargs['diseq_chem'] = True

opa_ck = jdi.opannection(ck_table=synthetic_ck_table(**ck_kwargs),
                         method='preweighted')
print('opannection done')
case = jdi.inputs(calculation='brown')
case.phase_angle(0)
case.gravity(gravity=100.0, gravity_unit=jdi.u.Unit('m/(s**2)'))
if mode == 'cloudy':
    teff = 400.0
case.effective_temp(teff)
case.setup_nostar()
case.setup_climate()
nlevel = 91
pressure = np.logspace(-4, 2.5, nlevel)
guess = np.clip(teff * (pressure / 10.0) ** 0.12, 250.0, 2800.0)
case.inputs_climate(temp_guess=guess, pressure=pressure,
                    rcb_guess=nlevel - 20, rfacv=0.0)
if mode == 'cloudy':
    case.inputs['climate']['cloudy'] = True
    case.inputs['climate']['virga_kwargs'] = {
        'condensates': ['H2O'], 'fsed': 3.0, 'mh': 1.0, 'mmw': 2.2}
if mode == 'diseq':
    case.inputs['approx']['chem_params']['quench'] = True
print('setup done; starting climate')
out = case.climate(opa_ck, verbose=True, **climate_kwargs)
print(f'DONE converged={bool(out["converged"])} '
      f'total={time.perf_counter() - t0:.1f}s')
