"""Every contraction on the main path asks for full f32 precision.

On an NVIDIA GPU an f32 dot_general without a precision may run in TF32
(about three decimal digits).  The bilinear weights of the opacity
interpolation multiply log10 kappa ~ -30, where that costs ~0.03 dex, so
each contraction of the lowered forward and of the climate Newton step
must carry HIGHEST.  Precision is a property of the traced program, so
lowering on the CPU shows what the GPU compiles.
"""

import dataclasses
import re

import jax
import numpy as np
import pytest

from picaso_tpu import pipeline


def _dot_lines(text):
    return [l for l in text.splitlines() if 'dot_general' in l]


def _assert_highest(text):
    dots = _dot_lines(text)
    assert dots, 'expected at least one contraction'
    loose = [l.strip() for l in dots
             if not re.search(r'precision\s*=\s*\[HIGHEST,\s*HIGHEST\]', l)]
    assert not loose, loose


@pytest.fixture(scope='module')
def small_forward():
    from bench import build_problem
    return build_problem(256, production=False)


@pytest.mark.parametrize('patch', [
    dict(thermal=False, transmission=False),        # reflected
    dict(reflected=False, transmission=False),      # thermal
    dict(reflected=False, thermal=False, transmission=True),
    dict(rt_method=1, stream=4),                    # SH4
])
def test_forward_contractions_are_highest(small_forward, patch):
    scene, grid, config = small_forward
    cfg = dataclasses.replace(config, **patch)
    _assert_highest(pipeline.forward.trace(scene, grid, cfg).lower(
        lowering_platforms=('cuda',)).as_text())


def test_profile_step_contractions_are_highest():
    from picaso_tpu import justdoit as jdi
    from picaso_tpu.climate import core, fused
    from picaso_tpu.climate.api import _ClimateState
    from picaso_tpu.opacities.ck import synthetic_ck_table

    nlevel = 21
    opa = jdi.opannection(ck_table=synthetic_ck_table(),
                          method='preweighted')
    case = jdi.inputs(calculation='brown', climate=True)
    case.phase_angle(0)
    case.gravity(gravity=100.0, gravity_unit=jdi.u.Unit('m/(s**2)'))
    case.effective_temp(700.0)
    case.setup_nostar()
    case.setup_climate()
    pressure = np.logspace(-4, 2.5, nlevel)
    guess = np.clip(700.0 * (pressure / 10.0) ** 0.12, 250.0, 2800.0)
    case.inputs_climate(temp_guess=guess, pressure=pressure,
                        rcb_guess=nlevel - 5, rfacv=0.0)
    opa.relative_flux = np.ones(len(opa.wno))
    state = _ClimateState(case, opa, core.tidal_flux(700.0, nlevel),
                          rfaci=1.0, rfacv=0.0, tmin=80.0, tmax=4000.0,
                          verbose=False)
    zones = core.zone_maps([0, nlevel - 5, nlevel - 2, 0, 0, 0], 1, nlevel)
    config = state.fused_config(it_max=1, egp_stepmax=False)

    def step(t):
        return fused.profile_step(t, zones, state.data, state.chem_grid,
                                  state.ck.arrays, state.geom,
                                  state.adiabat, config)

    _assert_highest(jax.jit(step).trace(guess).lower(
        lowering_platforms=('cuda',)).as_text())
