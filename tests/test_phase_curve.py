"""Batched (single-program) phase curves vs the per-phase path, and
mesh-sharded batches vs single-device."""

import numpy as np
import pytest

from picaso_tpu import justdoit as jdi
from picaso_tpu import parallel
from picaso_tpu.opacities import factory


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('pc') / 'syn.db')
    wno = np.linspace(2000.0, 12000.0, 200)
    factory.build_synthetic_db(path, wno, ntemp=6, npress=5)
    opa = jdi.opannection(filename_db=path)
    case = jdi.inputs()
    case.gravity(mass=1.0, mass_unit=jdi.u.Unit('M_jup'),
                 radius=1.1, radius_unit=jdi.u.Unit('R_jup'))
    case.phase_curve_geometry('reflected',
                              np.array([0.0, np.pi / 4, np.pi / 2]),
                              num_gangle=6, num_tangle=6)
    case.star(opa, 5700, 0.0, 4.4, radius=1.0,
              radius_unit=jdi.u.Unit('R_sun'), semi_major=0.05,
              semi_major_unit=jdi.u.Unit('au'))
    case.atmosphere(filename=jdi.jupiter_pt(), sep=r'\s+')
    return opa, case


def test_batched_matches_serial(setup):
    opa, case = setup
    serial = case.phase_curve(opa, verbose=False, batched=False)
    batched = case.phase_curve(opa, verbose=False, batched=True)
    assert set(serial) == set(batched)
    for phase in serial:
        np.testing.assert_allclose(
            batched[phase]['albedo'], serial[phase]['albedo'],
            rtol=2e-3, atol=1e-7)
        np.testing.assert_allclose(
            batched[phase]['fpfs_reflected'],
            serial[phase]['fpfs_reflected'], rtol=2e-3, atol=1e-12)


def test_batched_sharded_matches_unsharded(setup):
    """8-virtual-device ('batch', 'wave') mesh reproduces the
    single-device batched result."""
    opa, case = setup
    single = case.phase_curve(opa, verbose=False, batched=True)
    # 3 phases shard unevenly over batch=1 x wave=8; use wave sharding
    mesh = parallel.make_mesh(n_wave=8, n_batch=1)
    sharded = case.phase_curve(opa, verbose=False, batched=True,
                               mesh=mesh)
    for phase in single:
        np.testing.assert_allclose(sharded[phase]['albedo'],
                                   single[phase]['albedo'], rtol=1e-10)


def test_batched_thermal_phase_curve(setup):
    opa, case = setup
    case.phase_curve_geometry('thermal',
                              np.array([0.0, np.pi]), num_gangle=6,
                              num_tangle=6)
    try:
        out = case.phase_curve(opa, verbose=False, batched=True)
        serial = case.phase_curve(opa, verbose=False, batched=False)
    finally:
        case.phase_curve_geometry('reflected',
                                  np.array([0.0, np.pi / 4, np.pi / 2]),
                                  num_gangle=6, num_tangle=6)
    for phase in out:
        np.testing.assert_allclose(out[phase]['thermal'],
                                   serial[phase]['thermal'], rtol=2e-3)
        assert 'fpfs_thermal' in out[phase]


def test_compute_disco_phase_pi_finite():
    """phase = pi must be finite (upstream divides by cos_theta+1 = 0).

    The algebraic form (g*(c+1) - (c-1))/2 equals the reference's
    expression for every c != -1 and takes the analytic limit
    longitude = pi/2 at c = -1 (new-moon geometry: only the limb of the
    lit hemisphere faces the observer, ubar0 <= 0 everywhere).
    """
    import warnings

    import numpy as np

    from picaso_tpu import disco

    gangle, gweight, tangle, tweight = disco.get_angles_3d(6, 6)
    with warnings.catch_warnings():
        warnings.simplefilter('error')   # any divide-by-zero -> failure
        ubar0, ubar1, cos_theta, lat, lon = disco.compute_disco(
            6, 6, gangle, tangle, np.pi)
    assert np.all(np.isfinite(ubar0)) and np.all(np.isfinite(ubar1))
    np.testing.assert_allclose(lon, np.pi / 2, atol=1e-12)
    assert np.all(ubar0 <= 1e-12)

    # away from the singularity the algebraic form matches the
    # reference's division form exactly
    for phase in (0.3, 1.2, 2.5, 4.0):
        c = np.cos(phase)
        ref_lon = np.arcsin((gangle - (c - 1.0) / (c + 1.0))
                            / (2.0 / (c + 1.0)))
        if phase > np.pi:
            ref_lon = -ref_lon
        _, _, _, _, lon = disco.compute_disco(6, 6, gangle, tangle, phase)
        np.testing.assert_allclose(lon, ref_lon, rtol=1e-12)
