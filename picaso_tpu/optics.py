"""Optical-property assembly (single-scattering inputs for the RT kernels).

JAX port of the semantics of the reference's ``picaso/optics.py:26-432``
(``compute_opacity``).  The host/device split is different from the reference:

* opacity *lookup* (molecular/continuum interpolation in (T, P)) lives in
  :mod:`picaso_tpu.opacities` and runs fully on device from HBM-resident
  grids;
* this module takes the per-source optical depths (gas, rayleigh, cloud) and
  fuses them into the 13-field bundle consumed by the Toon/SH kernels,
  including the delta-Eddington rescaling and the analytic ``test_mode``
  overrides used by the Dlugach/Madhu literature validation tables
  (optics.py:372-399).

Everything here is jit-friendly: pure functions of arrays with static
string/enum options.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

__all__ = ['RTProps', 'combine_optics']


class RTProps(NamedTuple):
    """Per-layer single-scattering properties, the 13-tuple of optics.py:423.

    All arrays are [..., nlayer, nwno] except tau/tau_og which are
    [..., nlevel, nwno].  ``*_og`` fields are the values WITHOUT the
    delta-Eddington correction (used for single-scattering source terms and
    all thermal calculations); w0_no_raman additionally omits the Raman
    correction (justdoit.py:330-342).
    """
    dtau: jnp.ndarray
    tau: jnp.ndarray
    w0: jnp.ndarray
    cosb: jnp.ndarray
    ftau_cld: jnp.ndarray
    ftau_ray: jnp.ndarray
    gcos2: jnp.ndarray
    dtau_og: jnp.ndarray
    tau_og: jnp.ndarray
    w0_og: jnp.ndarray
    cosb_og: jnp.ndarray
    w0_no_raman: jnp.ndarray
    f_deltaM: jnp.ndarray

    def slice_gauss(self, ig):
        """Select one correlated-k gauss point (leading axis)."""
        return RTProps(*(x[ig] for x in self))


def _cumtau(dtau):
    """Cumulative tau from the top: [..., nlayer, nwno] -> [..., nlevel, nwno]."""
    zero = jnp.zeros_like(dtau[..., :1, :])
    return jnp.concatenate([zero, jnp.cumsum(dtau, axis=-2)], axis=-2)


@partial(jax.jit, static_argnames=('test_mode', 'delta_eddington', 'stream'))
def combine_optics(taugas, tauray, taucld, w0_cld, g0_cld, raman_factor,
                   test_mode: Optional[str] = None,
                   delta_eddington: bool = True,
                   stream: int = 2) -> RTProps:
    """Fuse per-source optical depths into the RT property bundle.

    Implements optics.py:327-431 exactly, including both return branches
    (delta-Eddington on/off) and the 'rayleigh' / 'constant_tau' test modes.
    Shapes: all [..., nlayer, nwno] (any leading batch axes, e.g. the CK
    gauss axis or a [cloudy, clear] patchy axis).
    """
    DTAU = taugas + tauray + taucld
    ftau_cld = (w0_cld * taucld) / (w0_cld * taucld + tauray)
    COSB = g0_cld
    ftau_ray = tauray / (tauray + w0_cld * taucld)
    GCOS2 = 0.5 * ftau_ray  # Hansen & Travis 1974
    W0 = (tauray * raman_factor + taucld * w0_cld) / DTAU
    W0_no_raman = (tauray * 0.99999 + taucld * w0_cld) / DTAU

    if test_mode is not None:
        # literature-table hooks (optics.py:372-399): overwrite the physical
        # opacities with analytic ones so RT kernels can be validated against
        # Dlugach & Yanovitskij / Madhu & Burrows without any database.
        if test_mode == 'rayleigh':
            DTAU = tauray
            GCOS2 = jnp.full_like(DTAU, 0.5)
            ftau_ray = jnp.ones_like(DTAU)
            ftau_cld = jnp.zeros_like(DTAU)
        else:  # 'constant_tau' and anything else: cloud opd as the only tau
            DTAU = taucld
            GCOS2 = jnp.zeros_like(DTAU)
            ftau_ray = jnp.zeros_like(DTAU)
            ftau_cld = jnp.ones_like(DTAU)
        w0_test = jnp.where(w0_cld <= 0, 1e-10, w0_cld)
        DTAU = jnp.where(DTAU <= 0, 1e-10, DTAU)
        COSB = g0_cld
        W0 = w0_test
        W0_no_raman = w0_test

    TAU = _cumtau(DTAU)

    if delta_eddington:
        # Joseph, Wiscombe & Weinman 1976 forward-peak rescaling
        # (optics.py:401-426)
        f_deltaM = COSB ** stream
        w0_dedd = W0 * (1.0 - f_deltaM) / (1.0 - W0 * f_deltaM)
        cosb_dedd = (COSB - f_deltaM) / (1.0 - f_deltaM)
        dtau_dedd = DTAU * (1.0 - W0 * f_deltaM)
        tau_dedd = _cumtau(dtau_dedd)
        return RTProps(dtau=dtau_dedd, tau=tau_dedd, w0=w0_dedd,
                       cosb=cosb_dedd, ftau_cld=ftau_cld, ftau_ray=ftau_ray,
                       gcos2=GCOS2, dtau_og=DTAU, tau_og=TAU, w0_og=W0,
                       cosb_og=COSB, w0_no_raman=W0_no_raman,
                       f_deltaM=f_deltaM)
    return RTProps(dtau=DTAU, tau=TAU, w0=W0, cosb=COSB, ftau_cld=ftau_cld,
                   ftau_ray=ftau_ray, gcos2=GCOS2, dtau_og=DTAU, tau_og=TAU,
                   w0_og=W0, cosb_og=COSB, w0_no_raman=W0_no_raman,
                   f_deltaM=0.0 * COSB)
