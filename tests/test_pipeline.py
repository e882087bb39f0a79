"""Fused pipeline: consistency with the stepwise API + mesh sharding."""

import jax
import numpy as np
import pytest

from picaso_tpu import justdoit as jdi
from picaso_tpu import parallel, pipeline
from picaso_tpu.opacities import factory


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('opa') / 'synthetic.db')
    wno = np.linspace(2000.0, 18000.0, 256)
    factory.build_synthetic_db(path, wno, ntemp=8, npress=6)
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
    return opa, case


def test_fused_matches_stepwise(setup):
    """The single-jit forward must reproduce the debuggable API path."""
    opa, case = setup
    ref = case.spectrum(opa, calculation='reflected+thermal')
    scene, config = pipeline.scene_from_case(case, opa, dtype=np.float64)
    out = pipeline.forward(scene, opa.grid, config)
    np.testing.assert_allclose(np.asarray(out['albedo']), ref['albedo'],
                               rtol=2e-3, atol=1e-6)
    # atol floors out the ~1e-27 erg Wien tail where the stepwise path's
    # scalar-gravity continuum integral differs from the pipeline's
    # per-layer gravity
    np.testing.assert_allclose(np.asarray(out['thermal']), ref['thermal'],
                               rtol=2e-3, atol=1e-12)


def test_fused_sh_matches_stepwise(setup):
    """SH 4-stream through the fused pipeline == stepwise SH path."""
    opa, case = setup
    case.approx(rt_method='SH', stream=4)
    try:
        ref = case.spectrum(opa, calculation='reflected+thermal')
        scene, config = pipeline.scene_from_case(case, opa,
                                                 dtype=np.float64)
        assert config.rt_method == 1 and config.stream == 4
        out = pipeline.forward(scene, opa.grid, config)
    finally:
        case.approx(rt_method='toon', stream=2)
    np.testing.assert_allclose(np.asarray(out['albedo']), ref['albedo'],
                               rtol=2e-3, atol=1e-6)
    np.testing.assert_allclose(np.asarray(out['thermal']), ref['thermal'],
                               rtol=2e-3, atol=1e-12)


@pytest.fixture(scope='module')
def setup_blue(tmp_path_factory):
    """Short-wavelength (0.3-0.5 um) case where Raman scattering matters."""
    path = str(tmp_path_factory.mktemp('opa_blue') / 'synthetic.db')
    wno = np.linspace(20000.0, 33000.0, 128)
    factory.build_synthetic_db(path, wno, ntemp=8, npress=6)
    opa = jdi.opannection(filename_db=path)
    case = jdi.inputs()
    case.phase_angle(0)
    case.gravity(gravity=25.0, gravity_unit=jdi.u.Unit('m/(s**2)'))
    case.star(opa, 5700, 0.0, 4.4)
    case.atmosphere(filename=jdi.jupiter_pt(), sep=r'\s+')
    return opa, case


@pytest.mark.parametrize('raman_name,code', [('oklopcic', 0),
                                             ('pollack', 1)])
def test_fused_raman_matches_stepwise(setup_blue, raman_name, code):
    """Raman modes run the same physics in the fused and stepwise paths
    (the fused path once silently substituted 'none')."""
    opa, case = setup_blue
    case.approx(raman=raman_name)
    # star() precomputes the raman stellar shifts only when the oklopcic
    # mode is already selected (as in the reference, justdoit.py:1833)
    case.star(opa, 5700, 0.0, 4.4)
    try:
        ref = case.spectrum(opa, calculation='reflected')
        scene, config = pipeline.scene_from_case(case, opa,
                                                 dtype=np.float64)
        assert config.raman == code
        out = pipeline.forward(scene, opa.grid, config)
    finally:
        case.approx(raman='none')
    np.testing.assert_allclose(np.asarray(out['albedo']), ref['albedo'],
                               rtol=2e-3, atol=1e-6)
    # and it is genuinely different physics from raman='none'
    scene2, config2 = pipeline.scene_from_case(case, opa, dtype=np.float64)
    out_none = pipeline.forward(scene2, opa.grid, config2)
    assert not np.allclose(np.asarray(out['albedo']),
                           np.asarray(out_none['albedo']), rtol=1e-4)


def test_transit_in_fused_pipeline(setup):
    opa, case = setup
    ref = case.spectrum(opa, calculation='transmission')
    scene, config = pipeline.scene_from_case(case, opa, dtype=np.float64)
    out = pipeline.forward(scene, opa.grid, config)
    np.testing.assert_allclose(np.asarray(out['transit_depth']),
                               ref['transit_depth'], rtol=1e-5)


def test_sharded_forward_matches_single_device(setup):
    """8-way wavelength sharding must be numerically identical."""
    opa, case = setup
    scene, config = pipeline.scene_from_case(case, opa, dtype=np.float64)
    single = pipeline.forward(scene, opa.grid, config)

    mesh = parallel.make_mesh(n_wave=8, n_batch=1)
    scene_s = parallel.shard_scene(scene, mesh)
    grid_s = parallel.shard_grid(opa.grid, mesh)
    sharded = parallel.sharded_forward(scene_s, grid_s, config, mesh)
    for k in single:
        np.testing.assert_allclose(np.asarray(sharded[k]),
                                   np.asarray(single[k]), rtol=1e-10)


def test_forward_is_retrace_free(setup):
    """Changing temperatures must not retrigger compilation."""
    opa, case = setup
    scene, config = pipeline.scene_from_case(case, opa, dtype=np.float64)
    pipeline.forward(scene, opa.grid, config)
    n0 = pipeline.forward._cache_size()
    hot = scene._replace(tlevel=scene.tlevel * 1.1,
                         tlayer=scene.tlayer * 1.1)
    pipeline.forward(hot, opa.grid, config)
    assert pipeline.forward._cache_size() == n0
