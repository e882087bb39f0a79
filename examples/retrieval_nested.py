"""Free retrieval on synthetic transmission data (nested sampling).

Miniature of the reference's free-retrieval template
(retrieval.py:38 create_template / scripts/free_retrieval.py) in the
Device-batched shape: every likelihood batch the sampler proposes becomes ONE
batched fused forward (`pipeline.stack_scenes` + `forward_batch`) — the
vmap replacement for the reference's MPI likelihood pool
(driver.py:406-427).
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

import tempfile

import numpy as np

from picaso_tpu import justdoit as jdi
from picaso_tpu import pipeline
from picaso_tpu.sampler import nested_sample
from picaso_tpu.opacities.factory import build_synthetic_db

db = os.path.join(tempfile.mkdtemp(), 'synthetic_opacities.db')
build_synthetic_db(db, wno=np.linspace(1e4 / 5.0, 1e4 / 1.0, 300),
                   molecules=('H2O', 'CH4'))
opa = jdi.opannection(filename_db=db)

nlevel = 21
pressure = np.logspace(-6, 2, nlevel)
RSTAR = 0.9 * 6.957e10


def make_scene(tiso, log_h2o):
    """SceneTensors for one (T_iso, log H2O) parameter point."""
    mix = {'H2': np.full(nlevel, 0.86), 'He': np.full(nlevel, 0.14),
           'H2O': np.full(nlevel, 10.0 ** log_h2o),
           'CH4': np.full(nlevel, 1e-4)}
    scene, config = pipeline.scene_from_arrays(
        pressure, np.full(nlevel, tiso), mix, opa.grid,
        gravity=np.nan, radius=1.2 * 7.1492e9, mass=0.8 * 1.898e30,
        rstar=RSTAR)
    return scene, config


_, config = make_scene(1000.0, -3.0)
import dataclasses
config = dataclasses.replace(config, reflected=False, thermal=False,
                             transmission=True)


def forward_batched(theta):
    """[n, 2] parameter points -> [n, nwno] transit depths, ONE device
    dispatch for the whole batch."""
    scenes = [make_scene(t, lw)[0] for t, lw in np.atleast_2d(theta)]
    batch = pipeline.stack_scenes(scenes)
    out = pipeline.forward_batch(batch, opa.grid, config)
    return np.asarray(out['transit_depth'])


truth = (1150.0, -3.2)
y_true = forward_batched([truth])[0]
rng = np.random.default_rng(0)
err = 0.02 * y_true.mean()
y_obs = y_true + rng.normal(0, err, y_true.shape)


def loglike(theta):
    depth = forward_batched(theta)
    return -0.5 * np.sum((depth - y_obs) ** 2 / err ** 2, axis=1)


def prior(u):
    u = np.atleast_2d(u).copy()
    u[:, 0] = 800.0 + 800.0 * u[:, 0]      # T_iso
    u[:, 1] = -5.0 + 3.0 * u[:, 1]         # log H2O
    return u


t0 = time.time()
res = nested_sample(loglike, prior, ndim=2, nlive=20, max_iter=60,
                    walks=5, seed=2)
dt = time.time() - t0
post = res.samples_equal
med = np.median(post, axis=0)
print(f'truth T={truth[0]} logH2O={truth[1]}')
print(f'posterior medians T={med[0]:.0f} logH2O={med[1]:.2f} '
      f'logZ={res.logz:.1f}  ({dt:.0f}s, batched likelihoods)')
assert abs(med[0] - truth[0]) < 250
assert abs(med[1] - truth[1]) < 1.0
