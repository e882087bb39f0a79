"""The fused Toon89 GPU kernel (rt/toon_kernel.py) against the scan path.

The kernel runs here in Pallas interpret mode (Triton route) in float64,
where it must reproduce the XLA scan path (combine_optics + toon
reflected_1d / thermal_1d) to rounding.  The backend choice is checked
by lowering the forward for CUDA and for the CPU.  The compiled kernel
runs only on the card: ``test_compiled_kernel_on_card`` is marked ``gpu``
and skips elsewhere (``python chip_smoke.py`` also runs it at full width).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from picaso_tpu import pipeline
from picaso_tpu.optics import combine_optics
from picaso_tpu.rt.toon import (ScatteringControls, blackbody, reflected_1d,
                                thermal_1d)
from picaso_tpu.rt.toon_kernel import BLOCK, toon_spectrum

TRITON_CALL = '__gpu$xla.gpu.triton'


def _problem(nlayer=12, nwno=300, nang=3, seed=11):
    """Per-source optical depths plus geometry; nwno=300 leaves a partial
    last tile (300 = 2 * 128 + 44)."""
    rng = np.random.default_rng(seed)
    src = dict(taugas=rng.uniform(1e-4, 1.5, (nlayer, nwno)),
               tauray=rng.uniform(1e-5, 0.3, (nlayer, nwno)),
               cld_opd=rng.uniform(0.0, 1.0, (nlayer, nwno)),
               cld_w0=rng.uniform(0.3, 0.99, (nlayer, nwno)),
               cld_g0=rng.uniform(0.0, 0.9, (nlayer, nwno)),
               rf=rng.uniform(0.9, 0.99999, (nlayer, nwno)))
    src = {k: jnp.asarray(v) for k, v in src.items()}
    geo = dict(ubar0=jnp.asarray(rng.uniform(0.1, 1.0, (nang, 1))),
               ubar1=jnp.asarray(rng.uniform(0.1, 1.0, (nang, 1))),
               surf=jnp.full(nwno, 0.1), F0PI=jnp.ones(nwno),
               tlevel=jnp.asarray(np.linspace(400.0, 1600.0, nlayer + 1)),
               plevel=jnp.asarray(np.logspace(-4, 2, nlayer + 1)),
               wno=jnp.asarray(np.linspace(300.0, 20000.0, nwno)))
    return src, geo


def _scan(src, geo, controls, delta_eddington, hard_surface):
    p = combine_optics(src['taugas'], src['tauray'], src['cld_opd'],
                       src['cld_w0'], src['cld_g0'], src['rf'],
                       delta_eddington=delta_eddington, stream=2)
    xint, _ = reflected_1d(
        p.dtau, p.tau, p.w0, p.cosb, p.gcos2, p.ftau_cld, p.ftau_ray,
        p.dtau_og, p.tau_og, p.w0_og, p.cosb_og, geo['surf'], geo['ubar0'],
        geo['ubar1'], 0.5, geo['F0PI'], controls)
    flux, _ = thermal_1d(geo['tlevel'], p.dtau_og, p.w0_no_raman, p.cosb_og,
                         geo['plevel'], geo['ubar1'], geo['surf'],
                         geo['wno'], dwno=jnp.zeros_like(geo['wno']),
                         hard_surface=hard_surface, calc_type=0)
    return xint, flux


def _kernel(src, geo, controls, delta_eddington, hard_surface,
            reflected=True, thermal=True):
    all_b = blackbody(geo['tlevel'], 1.0 / geo['wno'])
    ptfac = geo['plevel'][0] / (geo['plevel'][1] - geo['plevel'][0])
    return toon_spectrum(
        src['taugas'], src['tauray'], src['cld_opd'], src['cld_w0'],
        src['cld_g0'], src['rf'], all_b, ptfac, geo['surf'], geo['ubar0'],
        geo['ubar1'], 0.5, geo['F0PI'], controls=controls, stream=2,
        delta_eddington=delta_eddington, hard_surface=hard_surface,
        reflected=reflected, thermal=thermal, interpret=True)


@pytest.mark.parametrize('controls,delta_eddington,hard_surface,nwno', [
    (ScatteringControls(single_phase=3), True, False, 300),
    (ScatteringControls(single_phase=3), False, False, 300),
    (ScatteringControls(single_phase=1), True, False, 300),
    (ScatteringControls(single_phase=1), False, False, 300),
    (ScatteringControls(single_phase=3), True, True, 300),
    (ScatteringControls(single_phase=0, multi_phase=1,
                        toon_coefficients=1), True, False, 300),
    (ScatteringControls(single_phase=2), True, True, 100),   # < one tile
])
def test_dual_pass_matches_scan(controls, delta_eddington, hard_surface,
                                nwno):
    src, geo = _problem(nwno=nwno)
    ref_x, ref_t = _scan(src, geo, controls, delta_eddington, hard_surface)
    x, t = _kernel(src, geo, controls, delta_eddington, hard_surface)
    np.testing.assert_allclose(np.asarray(x), np.asarray(ref_x), rtol=1e-9)
    np.testing.assert_allclose(np.asarray(t), np.asarray(ref_t), rtol=1e-9)


@pytest.mark.parametrize('reflected,thermal', [(True, False),
                                               (False, True)])
def test_single_pass_matches_scan(reflected, thermal):
    src, geo = _problem(nlayer=9, nwno=2 * BLOCK + 3)
    c = ScatteringControls()
    ref_x, ref_t = _scan(src, geo, c, True, False)
    x, t = _kernel(src, geo, c, True, False, reflected=reflected,
                   thermal=thermal)
    assert (x is None) != reflected and (t is None) != thermal
    got, ref = (x, ref_x) if reflected else (t, ref_t)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-9)


def test_kernel_batches_under_vmap():
    """forward_batch vmaps the kernel: each batch member equals its own
    unbatched solve."""
    src, geo = _problem(nlayer=8, nwno=BLOCK + 5)
    c = ScatteringControls()
    scales = jnp.asarray([1.0, 1.7])

    def one(s):
        s_src = dict(src, taugas=src['taugas'] * s)
        return _kernel(s_src, geo, c, True, False)

    xb, tb = jax.vmap(one)(scales)
    for i, s in enumerate(np.asarray(scales)):
        x, t = one(s)
        np.testing.assert_allclose(np.asarray(xb[i]), np.asarray(x),
                                   rtol=1e-12)
        np.testing.assert_allclose(np.asarray(tb[i]), np.asarray(t),
                                   rtol=1e-12)


@pytest.fixture(scope='module')
def small_forward():
    from bench import build_problem
    return build_problem(256, production=False)


def _lowered(scene, grid, config, platform, fn=pipeline.forward):
    return fn.trace(scene, grid, config).lower(
        lowering_platforms=(platform,)).as_text()


@pytest.mark.parametrize('platform,expect_kernel', [('cuda', True),
                                                    ('cpu', False)])
def test_backend_choice(small_forward, platform, expect_kernel):
    """The Toon solve is the fused kernel when lowering for CUDA and the
    scan path on the CPU; forward_reference is the scan path anywhere."""
    scene, grid, config = small_forward
    assert (TRITON_CALL in _lowered(scene, grid, config, platform)) \
        == expect_kernel
    assert TRITON_CALL not in _lowered(scene, grid, config, platform,
                                       pipeline.forward_reference)


@pytest.mark.parametrize('patch', [dict(test_mode='rayleigh'),
                                   dict(rt_method=1, stream=4),
                                   dict(reflected=False, thermal=False)])
def test_scan_only_configurations(small_forward, patch):
    """Analytic test modes, the SH solver and transit-only spectra lower
    no kernel, even for CUDA."""
    scene, grid, config = small_forward
    cfg = dataclasses.replace(config, **patch)
    assert TRITON_CALL not in _lowered(scene, grid, cfg, 'cuda')


@pytest.mark.gpu
def test_compiled_kernel_on_card():
    """The compiled kernel against the scan path, both float32, on a GPU."""
    if jax.devices()[0].platform != 'gpu':
        pytest.skip('needs a GPU: the compiled kernel has no CPU form')
    from bench import build_problem
    scene, grid, config = build_problem(5000)
    out = pipeline.forward(scene, grid, config)
    ref = pipeline.forward_reference(scene, grid, config)
    for k in ('albedo', 'thermal'):
        np.testing.assert_allclose(np.asarray(out[k]), np.asarray(ref[k]),
                                   rtol=1e-4)
