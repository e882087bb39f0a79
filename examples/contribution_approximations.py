"""Contribution functions + RT approximation sweep.

Mirrors the reference's "useful tools" and "RT approximations" notebook
categories: per-species tau=1 pressure surfaces (get_contribution), and
the same scene solved with Toon quadrature/eddington coefficients, the
spherical-harmonics 2- and 4-stream methods, and different
single-scattering phase functions.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

import tempfile

import jax

# the SH 2/4-stream sweep below needs float64 (rt/sh.py conditioning
# note)
jax.config.update('jax_enable_x64', True)

import numpy as np

from picaso_tpu import justdoit as jdi
from picaso_tpu.opacities.factory import build_synthetic_db

db = os.path.join(tempfile.mkdtemp(), 'synthetic_opacities.db')
build_synthetic_db(db, wno=np.linspace(1e4 / 2.0, 1e4 / 0.4, 1500),
                   molecules=('H2O', 'CH4', 'CO2'))
opa = jdi.opannection(filename_db=db)

case = jdi.inputs()
case.phase_angle(0)
case.gravity(gravity=25.0, gravity_unit=jdi.u.Unit('m/(s**2)'))
case.star(opa, 5800.0, 0.0, 4.4, radius=1.0,
          radius_unit=jdi.u.Unit('Rsun'), semi_major=0.05,
          semi_major_unit=jdi.u.Unit('au'))
nlevel = 41
pressure = np.logspace(-6, 2, nlevel)
case.atmosphere(df=jdi.pd.DataFrame({
    'pressure': pressure,
    'temperature': np.clip(1100.0 * (pressure / 10.0) ** 0.1, 250.0, None),
    'H2': 0.84, 'He': 0.15, 'H2O': 1e-3, 'CH4': 3e-4, 'CO2': 1e-6}))

# --- contribution functions (justdoit.py:1090-1295) ---
contrib = jdi.get_contribution(case, opa, at_tau=1.0)
taus, cumsum, tau_p = (contrib['taus_per_layer'], contrib['cumsum_taus'],
                       contrib['tau_p_surface'])
for mol, press in tau_p.items():
    p = np.asarray(press)
    good = np.isfinite(p)
    print(f'tau=1 surface {mol:>6}: median '
          f'{np.median(p[good]):.3g} bar' if good.any() else
          f'tau=1 surface {mol:>6}: optically thin everywhere')
assert set(taus) >= {'H2O', 'CH4', 'CO2'}

# --- RT approximation sweep ---
results = {}
for label, kw in [
        ('toon-quadrature', dict(toon_coefficients='quadrature')),
        ('toon-eddington', dict(toon_coefficients='eddington')),
        ('OTHG phase', dict(single_phase='OTHG')),
        ('TTHG_ray phase', dict(single_phase='TTHG_ray')),
        ('SH 2-stream', dict(rt_method='SH', stream=2)),
        ('SH 4-stream', dict(rt_method='SH', stream=4))]:
    case.approx(**kw)
    out = case.spectrum(opa, calculation='reflected')
    alb = np.asarray(out['albedo'])
    assert np.isfinite(alb).all(), label
    results[label] = float(alb.mean())
    print(f'{label:>16}: mean albedo {results[label]:.4f}')
    case.approx()   # reset defaults

# methods must agree to leading order on this cloud-free scene
vals = np.array(list(results.values()))
assert vals.std() / vals.mean() < 0.25
print('PASS contribution + approximations')
