"""Device-mesh SPMD: sharded retrieval likelihoods + a sharded RCE solve.

Demonstrates the two whole-workload mesh surfaces (SURVEY.md §2.4's
device-mesh equivalents of the reference's MPI pool and serial climate loop):

1. A nested-sampling retrieval whose likelihood batches shard live
   points over the mesh 'batch' axis and wavelengths over 'wave'
   (``parallel.sharded_loglike`` — drop-in for
   ``sampler.nested_sample``; replaces driver.py:406-427's MPIPool).
2. A FULL radiative-convective climate solve (both profile passes and
   the find_strat zone search) running SPMD on the mesh via
   ``case.climate(opa, mesh=...)``.

Runs anywhere: on a multi-GPU host the mesh axes map to
the cards; here it uses 8 virtual CPU devices so the example is
self-contained.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

os.environ.setdefault('JAX_PLATFORMS', 'cpu')
flags = os.environ.get('XLA_FLAGS', '')
if 'xla_force_host_platform_device_count' not in flags:
    os.environ['XLA_FLAGS'] = (
        flags + ' --xla_force_host_platform_device_count=8').strip()

import jax

jax.config.update('jax_platforms', 'cpu')

import jax.numpy as jnp
import numpy as np

from picaso_tpu import parallel, pipeline
from picaso_tpu.opacities import factory
from picaso_tpu.sampler import nested_sample

print(f'devices: {len(jax.devices())}')
mesh = parallel.make_mesh(n_wave=4, n_batch=2)
print(f"mesh: {dict(mesh.shape)}")

# ---- 1. mesh-sharded retrieval ----------------------------------------
nwno = 256
wno = np.linspace(2000.0, 18000.0, nwno)
grid = factory.synthetic_opacity_grid(wno, ntemp=6, npress=5)
nlevel = 25
pressure = np.logspace(-6, 2, nlevel)
temperature = 1000.0 * (pressure / 10.0) ** 0.1 + 300.0
mix = {'H2': np.zeros(nlevel) + 0.85, 'He': np.zeros(nlevel) + 0.14,
       'H2O': np.zeros(nlevel) + 5e-4, 'CH4': np.zeros(nlevel) + 3e-4}
scene, config = pipeline.scene_from_arrays(
    pressure, temperature, mix, grid, gravity=2500.0, radius=7.1e9,
    mass=1.9e30, rstar=6.96e10)

truth = 1.05          # retrieved parameter: a temperature scale factor
grid_s = parallel.shard_grid(grid, mesh)


def model_batch(scales, grid_in):
    def one(s):
        sc = scene._replace(tlevel=scene.tlevel * s[0],
                            tlayer=scene.tlayer * s[0])
        return pipeline.forward(sc, grid_in, config)['albedo']
    return jax.vmap(one)(scales)


y = np.asarray(jax.jit(model_batch)(jnp.asarray([[truth]]), grid_s))[0]
y_s = jax.device_put(y, jax.sharding.NamedSharding(
    mesh, jax.sharding.PartitionSpec('wave')))


@jax.jit
def ll_dev(scales, grid_in, y_in):
    alb = model_batch(scales, grid_in)
    return -0.5 * jnp.sum((alb - y_in[None]) ** 2, -1) / 1e-6


loglike = parallel.sharded_loglike(lambda x: ll_dev(x, grid_s, y_s), mesh)
res = nested_sample(loglike, lambda u: 0.9 + 0.3 * u, 1, nlive=50,
                    seed=3, dlogz=0.5)
mean = float((res.samples[:, 0] * res.weights).sum())
print(f'retrieved scale = {mean:.4f} (truth {truth}), '
      f'logz = {res.logz:.2f}, {len(res.samples)} posterior samples')
assert abs(mean - truth) < 2e-2

# ---- 2. full sharded climate solve ------------------------------------
from picaso_tpu import justdoit as jdi
from picaso_tpu.opacities.ck import CKTable, synthetic_ck_table

ck = synthetic_ck_table()
a = ck.arrays
n = len(np.asarray(a.wno))
sl = np.s_[:(n // 16) * 16:4]          # 48 bins, divisible by the mesh
ck = CKTable(a._replace(wno=a.wno[sl], delta_wno=a.delta_wno[sl],
                        ln_kappa=a.ln_kappa[:, :, sl, :],
                        cont_opa=a.cont_opa[:, :, sl]),
             ck.molecules, ck.full_abunds, ck.gauss_pts, ck.temps,
             ck.pressures, wno=ck.wno[sl], delta_wno=ck.delta_wno[sl],
             gauss_wts=ck.gauss_wts)

opa = jdi.opannection(ck_table=ck, method='preweighted')
case = jdi.inputs(calculation='brown', climate=True)
case.phase_angle(0)
case.gravity(gravity=100.0, gravity_unit=jdi.u.Unit('m/(s**2)'))
case.effective_temp(700.0)
case.setup_nostar()
case.setup_climate()
nlevel = 41
pressure = np.logspace(-4, 2.5, nlevel)
guess = np.clip(700.0 * (pressure / 10.0) ** 0.12, 250.0, 2800.0)
case.inputs_climate(temp_guess=guess, pressure=pressure,
                    rcb_guess=nlevel - 8, rfacv=0.0)
out = case.climate(opa, verbose=False, mesh=mesh)
print(f"sharded RCE: converged={bool(out['converged'])}, "
      f"T = {out['temperature'].min():.0f}..{out['temperature'].max():.0f} K, "
      f"conv zones at nstr={out['cvz_locs']}")
assert out['converged']
print('ok')
