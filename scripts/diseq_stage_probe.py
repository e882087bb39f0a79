"""Per-stage timing of one diseq host iteration (diagnosis)."""
import sys
import time

sys.path.insert(0, '.')

import numpy as np
import jax
import jax.numpy as jnp

np.asarray(jnp.zeros(1))

from picaso_tpu import justdoit as jdi
from picaso_tpu.opacities.ck import synthetic_ck_table
from picaso_tpu.climate import api as capi
from picaso_tpu.climate import core, fused

opa_ck = jdi.opannection(ck_table=synthetic_ck_table(with_per_gas=True),
                         method='preweighted')
case = jdi.inputs(calculation='brown')
case.phase_angle(0)
case.gravity(gravity=100.0, gravity_unit=jdi.u.Unit('m/(s**2)'))
case.effective_temp(700.0)
case.setup_nostar()
case.setup_climate()
nlevel = 91
pressure = np.logspace(-4, 2.5, nlevel)
guess = np.clip(700.0 * (pressure / 10.0) ** 0.12, 250.0, 2800.0)
case.inputs_climate(temp_guess=guess, pressure=pressure, rcb_guess=60,
                    rfacv=0.0)

tidal = core.tidal_flux(700.0, nlevel)
state = capi._ClimateState(case, opa_ck, tidal, rfaci=1.0, rfacv=0.0,
                           tmin=40.0, tmax=4000.0, verbose=False)
state.diseq = True
state.self_consistent_kzz = True
temp = guess.copy()
pbar = pressure
nstr = [0, 60, 83, 0, 0, 0]
zones = core.zone_maps(nstr, 1, nlevel)
config = state.fused_config(it_max=8, egp_stepmax=False)


def t(label, fn, n=3):
    fn()  # warm (compile)
    t0 = time.perf_counter()
    for _ in range(n):
        r = fn()
    jax.block_until_ready(r) if hasattr(r, 'block_until_ready') else None
    print(f'{label:26s} {(time.perf_counter() - t0) / n * 1e3:8.1f} ms')
    return r


temp2 = t('reconstruct_host', lambda: capi._reconstruct_host(
    state, temp, pbar, nstr, 1))
df = t('update_diseq_chem', lambda: state.update_diseq_chem(temp, pbar))
pa = t('build_props_host', lambda: state.build_props_host(df))
props, atm = pa


def newton():
    out = fused.newton_solve(jnp.asarray(temp), props, zones, state.data,
                             state.geom, state.ck.arrays, state.adiabat,
                             config)
    jax.block_until_ready(out)
    return out


t('newton_solve (it_max=8)', newton)


def full_get():
    out = fused.newton_solve(jnp.asarray(temp), props, zones, state.data,
                             state.geom, state.ck.arrays, state.adiabat,
                             config)
    return jax.device_get(out)


t('newton + device_get', full_get)
