"""Batched tridiagonal / banded solvers for the RT two-stream systems.

The reference solves one 2*nlayer tridiagonal system *per wavelength* in a
Python loop under numba (``fluxes.py:289-323`` tri_diag_solve, called from
``fluxes.py:1202-1208`` and ``:1826-1831``).  Here the wavelength axis is the
vectorized axis: a single lax.scan over the 2*nlayer rows sweeps *all*
wavelengths at once.  2*nlayer is ~120-180, so the scan is short and each
step is a fused elementwise op over a [nwno] vector.  On a GPU each step
is a separate small kernel; the fused kernel of :mod:`.toon_kernel` does
the same elimination inside one program instead.

The elimination order matches the reference bit-for-bit: a *reverse* sweep
(last row first) followed by a forward substitution, i.e. the mirror image
of the textbook Thomas algorithm.  Keeping the same order keeps rounding
behaviour identical to the numba kernels, which matters for golden-file
parity on near-conservative scattering cases.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ['tridiag_solve', 'setup_tri_diag', 'solve_two_stream']


def tridiag_solve(a, b, c, d):
    """Solve a[i]*x[i-1] + b[i]*x[i] + c[i]*x[i+1] = d[i] for each column.

    All inputs have shape [L, ...]; the solve runs along axis 0 and is
    vectorized over every trailing axis.  Mirrors fluxes.py:289-323.
    """
    # reverse elimination: AS[i], DS[i] computed from row i+1 downward
    def back(carry, row):
        as_next, ds_next = carry
        ai, bi, ci, di = row
        x = 1.0 / (bi - ci * as_next)
        as_i = ai * x
        ds_i = (di - ci * ds_next) * x
        return (as_i, ds_i), (as_i, ds_i)

    as_last = a[-1] / b[-1]
    ds_last = d[-1] / b[-1]
    (_, _), (AS, DS) = jax.lax.scan(
        back, (as_last, ds_last), (a[:-1], b[:-1], c[:-1], d[:-1]),
        reverse=True)
    AS = jnp.concatenate([AS, as_last[None]], axis=0)
    DS = jnp.concatenate([DS, ds_last[None]], axis=0)

    # forward substitution: XK[i] = DS[i] - AS[i]*XK[i-1]
    def fwd(x_prev, row):
        as_i, ds_i = row
        x_i = ds_i - as_i * x_prev
        return x_i, x_i

    x0 = DS[0]
    _, XK = jax.lax.scan(fwd, x0, (AS[1:], DS[1:]))
    return jnp.concatenate([x0[None], XK], axis=0)


def setup_tri_diag(c_plus_up, c_minus_up, c_plus_down, c_minus_down,
                   b_top, b_surface, surf_reflect, gama, dtau,
                   exptrm_positive, exptrm_minus):
    """Toon89 eqn 44 interleaved tridiagonal coefficients.

    Inputs are [nlayer, nwno] (b_top/b_surface broadcastable over nwno);
    returns A, B, C, D with shape [2*nlayer, nwno].  Port of the semantics
    of fluxes.py:89-183 using interleaved scatter-free construction.
    """
    nlayer, nwno = dtau.shape
    L = 2 * nlayer

    e1 = exptrm_positive + gama * exptrm_minus
    e2 = exptrm_positive - gama * exptrm_minus
    e3 = gama * exptrm_positive + exptrm_minus
    e4 = gama * exptrm_positive - exptrm_minus

    dtype = dtau.dtype
    zeros_row = jnp.zeros((nwno,), dtype)

    # odd rows (python index 0,2,4,...): first row is the TOA boundary
    #   A_odd[0]=0, B_odd[0]=gama[0]+1, C_odd[0]=gama[0]-1, D_odd[0]=b_top-c_minus_up[0]
    #   A_odd[n>=1] = 2*(1-gama[n-1]^2)
    #   B_odd[n>=1] = (e1[n-1]-e3[n-1])*(gama[n]+1)
    #   C_odd[n>=1] = (e1[n-1]+e3[n-1])*(gama[n]-1)
    #   D_odd[n>=1] = e3[n-1]*(c_plus_up[n]-c_plus_down[n-1]) + e1[n-1]*(c_minus_down[n-1]-c_minus_up[n])
    A_odd = jnp.concatenate([zeros_row[None],
                             2.0 * (1.0 - gama[:-1] ** 2)], axis=0)
    B_odd = jnp.concatenate([(gama[0] + 1.0)[None],
                             (e1[:-1] - e3[:-1]) * (gama[1:] + 1.0)], axis=0)
    C_odd = jnp.concatenate([(gama[0] - 1.0)[None],
                             (e1[:-1] + e3[:-1]) * (gama[1:] - 1.0)], axis=0)
    D_odd = jnp.concatenate([
        (jnp.broadcast_to(b_top, (nwno,)).astype(dtype) - c_minus_up[0])[None],
        e3[:-1] * (c_plus_up[1:] - c_plus_down[:-1])
        + e1[:-1] * (c_minus_down[:-1] - c_minus_up[1:])], axis=0)

    # even rows (python index 1,3,...,L-1): last row is the surface boundary
    #   A_even[n<last] = (e1[n]+e3[n])*(gama[n+1]-1)
    #   B_even[n<last] = (e2[n]+e4[n])*(gama[n+1]-1)
    #   C_even[n<last] = 2*(1-gama[n+1]^2)
    #   D_even[n<last] = (gama[n+1]-1)*(c_plus_up[n+1]-c_plus_down[n]) + (1-gama[n+1])*(c_minus_down[n]-c_minus_up[n+1])
    #   last: A=e1-R*e3, B=e2-R*e4, C=0, D=b_surface-c_plus_down[-1]+R*c_minus_down[-1]
    sr = surf_reflect
    A_even = jnp.concatenate([
        (e1[:-1] + e3[:-1]) * (gama[1:] - 1.0),
        (e1[-1] - sr * e3[-1])[None]], axis=0)
    B_even = jnp.concatenate([
        (e2[:-1] + e4[:-1]) * (gama[1:] - 1.0),
        (e2[-1] - sr * e4[-1])[None]], axis=0)
    C_even = jnp.concatenate([
        2.0 * (1.0 - gama[1:] ** 2),
        zeros_row[None]], axis=0)
    D_even = jnp.concatenate([
        (gama[1:] - 1.0) * (c_plus_up[1:] - c_plus_down[:-1])
        + (1.0 - gama[1:]) * (c_minus_down[:-1] - c_minus_up[1:]),
        (jnp.broadcast_to(b_surface, (nwno,)).astype(dtype)
         - c_plus_down[-1] + sr * c_minus_down[-1])[None]], axis=0)

    def interleave(odd, even):
        return jnp.stack([odd, even], axis=1).reshape(L, nwno)

    return (interleave(A_odd, A_even), interleave(B_odd, B_even),
            interleave(C_odd, C_even), interleave(D_odd, D_even))


def solve_two_stream(c_plus_up, c_minus_up, c_plus_down, c_minus_down,
                     b_top, b_surface, surf_reflect, gama, dtau,
                     exptrm_positive, exptrm_minus):
    """Set up and solve the Toon89 system; returns (positive, negative).

    positive/negative are the Y1/Y2 coefficient fields [nlayer, nwno]
    obtained by un-mixing the interleaved solution exactly as
    fluxes.py:1202-1208 does.
    """
    A, B, C, D = setup_tri_diag(c_plus_up, c_minus_up, c_plus_down,
                                c_minus_down, b_top, b_surface, surf_reflect,
                                gama, dtau, exptrm_positive, exptrm_minus)
    X = tridiag_solve(A, B, C, D)
    nlayer = dtau.shape[0]
    Xo = X[0::2]
    Xe = X[1::2]
    positive = Xo + Xe
    negative = Xo - Xe
    return positive, negative
