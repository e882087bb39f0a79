"""Transmission spectroscopy: tangent-path slant optical depths.

Jax port of ``get_transit_1d`` (``/root/reference/picaso/fluxes.py:2582-2663``,
Brown 2001 eqn 11).  The reference builds the chord-segment matrix with a
double Python loop per call; here it is one masked broadcast expression, and
the per-wavelength accumulation is a single [nlevel, nlevel] x
[nlevel, nwno] matrix product, at full f32 precision.

Numerical note: the chord segment sqrt(outer^2 - ref^2) is computed as
sqrt((outer-ref)*(outer+ref)) — algebraically identical, but avoids the
catastrophic cancellation of squaring ~1e9 cm radii first, which keeps the
kernel accurate in float32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..constants import AMU, K_B

__all__ = ['transit_depth', 'chord_matrix']

HIGHEST = jax.lax.Precision.HIGHEST


def chord_matrix(z, plevel, tlevel):
    """M [nlevel, nlayer]: path-weighted chord segments (fluxes.py:2624-2644).

    M[i, k] is the contribution of layer k (bounded by levels k, k+1) to the
    slant column at impact level i: segment length x p/(T k_B), nonzero for
    k < i.  z decreasing with index (cm); plevel dyne/cm^2; tlevel K.
    """
    nlevel = z.shape[0]
    zi = z[:, None]            # reference shell (impact radius), [i, 1]
    zk_out = z[None, :-1]      # outer shell of layer k
    zk_in = z[None, 1:]        # inner shell of layer k

    def seg(outer, ref):
        d = (outer - ref) * (outer + ref)
        return jnp.sqrt(jnp.maximum(d, 0.0))

    # (inner == ref) happens at k = i-1; then the segment is just the outer
    # term (fluxes.py:2636-2639)
    segment = seg(zk_out, zi) - seg(zk_in, zi)
    k_idx = jnp.arange(nlevel - 1)[None, :]
    i_idx = jnp.arange(nlevel)[:, None]
    mask = k_idx < i_idx
    weight = plevel[None, :-1] / tlevel[None, :-1] / K_B
    return jnp.where(mask, segment * weight, 0.0)


@jax.jit
def transit_depth(z, dz, rstar, mmw_layer, plevel, tlevel, colden, dtau):
    """(Rp/Rs)^2 transit spectrum [nwno] (fluxes.py:2582-2663).

    dtau: [nlayer, nwno] total layer optical depth (gas+ray+cloud, no
    delta-Eddington); colden/mmw_layer per layer; z/dz per level (cm).
    """
    mmw_g = mmw_layer * AMU
    M = chord_matrix(z, plevel, tlevel)                     # [nlevel, nlayer]
    # per-layer extinction per unit slant column (fluxes.py:2648-2650)
    xsec = dtau * (mmw_g / colden)[:, None]                 # [nlayer, nwno]
    tau_slant = 2.0 * jnp.matmul(M.astype(xsec.dtype), xsec,
                                 precision=HIGHEST)         # [nlevel, nwno]
    transmitted = jnp.exp(-tau_slant)
    F = ((jnp.min(z) / rstar) ** 2
         + 2.0 / rstar ** 2 * jnp.matmul((1.0 - transmitted).T, z * dz,
                                         precision=HIGHEST))
    return F
