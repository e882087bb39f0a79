"""Toon89 reflected + thermal top-of-atmosphere solve as one GPU kernel.

The XLA form of the solve (:func:`picaso_tpu.rt.toon.reflected_1d`,
:func:`~picaso_tpu.rt.toon.thermal_1d` and the Thomas solve of
:mod:`picaso_tpu.rt.tridiag`) runs 90- to 180-step ``lax.scan``s whose
every step is a few small kernels over [nwno] (times the disk angles),
and writes each per-angle [nlayer, nwno] intermediate to device memory.
This Pallas kernel (Triton route) fuses the optics assembly, both
two-stream solves and the intensity sweeps: one program per tile of
``BLOCK`` wavelengths, one wavelength per lane, the layers walked in loops
inside the program.

Per tile, three layer loops:

1. top -> bottom: the cumulative delta-Eddington optical depth (the
   reflected beam attenuation needs it on the way up);
2. bottom -> top: the reverse Thomas elimination of the interleaved
   Toon89 eqn-44 system, in the reference's row order (fluxes.py:289-323).
   The matrix does not depend on the disk angle, so its multipliers are
   formed once; each angle carries only its right-hand side;
3. top -> bottom: the forward substitution, the layer source terms and
   the top-of-atmosphere intensity.  The upward recursion
   ``x[i] = x[i+1] * t[i] + s[i]`` is summed from the top as
   ``sum_i s[i] * prod_{j<i} t[j]``, so no per-layer solution is stored.

Only the elimination's per-row results cross loops; they go to a scratch
result in device memory that each program reads back itself.  The
arithmetic per layer is that of the scan path; results differ from it in
summation order only.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .toon import (ScatteringControls, _beam_g3, _dither_u0, _exp_clip,
                   _multi_phase, _reflected_coefficients, _resonant_ratio,
                   _single_phase)

__all__ = ['toon_spectrum', 'BLOCK']

BLOCK = 128       # wavelengths per program (one per lane)
NUM_WARPS = 4
NUM_STAGES = 1
_MU1 = 0.5        # thermal hemispheric mean (fluxes.py:1748)


def _records(nang, reflected, thermal):
    """Scratch rows per layer: name -> offset, and the count."""
    names = []
    if reflected:
        names += ['tau', 'r_aso', 'r_ase']
        names += [f'r_dso{a}' for a in range(nang)]
        names += [f'r_dse{a}' for a in range(nang)]
    if thermal:
        names += ['t_aso', 't_ase', 't_dso0', 't_dse0']
    return {n: i for i, n in enumerate(names)}, len(names)


def _optics(tg, tr, copd, cw0, cg0, rf, stream, delta_eddington):
    """combine_optics (optics.py:327-431, default branch) for one layer."""
    dtau_og = tg + tr + copd
    cldw = cw0 * copd
    ftau_cld = cldw / (cldw + tr)
    ftau_ray = tr / (tr + cldw)
    w0_og = (tr * rf + cldw) / dtau_og
    if delta_eddington:
        f = cg0 ** int(stream)
        w0 = w0_og * (1.0 - f) / (1.0 - w0_og * f)
        cosb = (cg0 - f) / (1.0 - f)
        dtau = dtau_og * (1.0 - w0_og * f)
    else:
        w0, cosb, dtau = w0_og, cg0, dtau_og
    return dict(dtau=dtau, w0=w0, cosb=cosb, ftau_cld=ftau_cld,
                ftau_ray=ftau_ray, gcos2=0.5 * ftau_ray, dtau_og=dtau_og,
                w0_og=w0_og, cosb_og=cg0,
                # thermal uses the OG fields with the fixed no-raman
                # albedo (justdoit.py:330-342)
                w0_no_raman=(tr * 0.99999 + cldw) / dtau_og)


def _kernel(u0_ref, u1_ref, scal_ref, rows_ref, tg_ref, tr_ref, copd_ref,
            cw0_ref, cg0_ref, rf_ref, allb_ref, *out_refs, nlayer, nwno,
            nang, controls, stream, delta_eddington, hard_surface,
            reflected, thermal, interpret):
    scr_ref = out_refs[-1]
    xint_ref = out_refs[0] if reflected else None
    therm_ref = out_refs[-2] if thermal else None
    rec, nrec = _records(nang, reflected, thermal)

    c0 = pl.program_id(0).astype(jnp.int32) * BLOCK
    lane_ok = c0 + jnp.arange(BLOCK) < nwno

    # one index type throughout (loop counters are 64-bit under x64)
    def load(ref, row):
        row = jnp.asarray(row, jnp.int32)
        return plgpu.load(ref.at[row, pl.ds(c0, BLOCK)], mask=lane_ok,
                          other=1.0)

    def store(ref, row, val):
        row = jnp.asarray(row, jnp.int32)
        plgpu.store(ref.at[row, pl.ds(c0, BLOCK)], val, mask=lane_ok)

    def rd(n, name):
        return load(scr_ref, n * nrec + rec[name])

    def wr(n, name, val):
        store(scr_ref, n * nrec + rec[name], val)

    def sync():
        # pass boundaries: the next pass reads what this one wrote
        if not interpret:
            plgpu.debug_barrier()

    cos_theta = scal_ref[0]
    ptfac = scal_ref[1]
    surf = load(rows_ref, 0)
    F0PI = load(rows_ref, 1)
    u0s = [u0_ref[a] for a in range(nang)]
    u1s = [u1_ref[a] for a in range(nang)]
    clip = _exp_clip(surf.dtype)
    PI = np.pi

    def optics(n):
        return _optics(load(tg_ref, n), load(tr_ref, n), load(copd_ref, n),
                       load(cw0_ref, n), load(cg0_ref, n), load(rf_ref, n),
                       stream, delta_eddington)

    def refl_layer(o, tau):
        """Angle-independent reflected quantities of one layer, plus
        the beam-source terms c+- (top and bottom) of every angle."""
        g1, g2, lamda, gama = _reflected_coefficients(
            o['w0'], o['ftau_cld'], o['cosb'], controls)
        exptrm = jnp.minimum(lamda * o['dtau'], clip)
        ep = jnp.exp(exptrm)
        em = 1.0 / ep
        L = dict(g1=g1, g2=g2, lamda=lamda, gama=gama, ep=ep, em=em,
                 e1=ep + gama * em, e2=ep - gama * em,
                 e3=gama * ep + em, e4=gama * ep - em)
        beams = []
        for u0 in u0s:
            g3 = _beam_g3(o['ftau_cld'], o['cosb'], u0, controls)
            g4 = 1.0 - g3
            u0b = _dither_u0(lamda, u0)
            den = lamda ** 2 - 1.0 / u0b ** 2
            a_minus = F0PI * o['w0'] * (g4 * (g1 + 1.0 / u0b) + g2 * g3) / den
            a_plus = F0PI * o['w0'] * (g3 * (g1 - 1.0 / u0b) + g2 * g4) / den
            x_up = jnp.exp(-tau / u0b)
            e_u0dt = jnp.exp(-o['dtau'] / u0b)
            x_dn = x_up * e_u0dt
            beams.append(dict(cpu=a_plus * x_up, cmu=a_minus * x_up,
                              cpd=a_plus * x_dn, cmd=a_minus * x_dn,
                              e_u0dt=e_u0dt))
        return L, beams

    def therm_layer(o, n):
        """Thermal two-stream quantities of one layer (fluxes.py:1756-1800)."""
        dtau = o['dtau_og']
        w0 = o['w0_no_raman']
        cosb = o['cosb_og']
        b0 = load(allb_ref, n)
        b1 = (load(allb_ref, n + 1) - b0) / dtau
        g1 = 2.0 - w0 * (1.0 + cosb)
        g2 = w0 * (1.0 - cosb)
        lamda = jnp.sqrt(g1 ** 2 - g2 ** 2)
        gama = g2 / (g1 + lamda)
        g1_plus_g2 = 1.0 / (g1 + g2)
        twopimu = 2.0 * PI * _MU1
        exptrm = jnp.minimum(lamda * dtau, clip)
        ep = jnp.exp(exptrm)
        em = 1.0 / ep
        return dict(dtau=dtau, b0=b0, b1=b1, lamda=lamda, gama=gama,
                    g1_plus_g2=g1_plus_g2, exptrm=exptrm, ep=ep, em=em,
                    e1=ep + gama * em, e2=ep - gama * em,
                    e3=gama * ep + em, e4=gama * ep - em,
                    cpu=twopimu * (b0 + b1 * g1_plus_g2),
                    cmu=twopimu * (b0 - b1 * g1_plus_g2),
                    cpd=twopimu * (b0 + b1 * dtau + b1 * g1_plus_g2),
                    cmd=twopimu * (b0 + b1 * dtau - b1 * g1_plus_g2))

    # -- pass 1, top -> bottom: level optical depth above each layer ----
    if reflected:
        def tau_down(n, tau):
            wr(n, 'tau', tau)
            return tau + optics(n)['dtau']

        tau_total = jax.lax.fori_loop(0, nlayer, tau_down,
                                      jnp.zeros_like(surf))
        sync()

    # -- pass 2, bottom -> top: reverse Thomas elimination --------------
    # (tridiag.setup_tri_diag rows; tridiag.tridiag_solve recurrences)
    def odd_row(lo, hi, cm_lo, cp_lo, cm_hi, cp_hi):
        """Row 2n for layer n = hi (>= 1) from layers lo = n-1 and hi."""
        A = 2.0 * (1.0 - lo['gama'] ** 2)
        B = (lo['e1'] - lo['e3']) * (hi['gama'] + 1.0)
        C = (lo['e1'] + lo['e3']) * (hi['gama'] - 1.0)
        D = [lo['e3'] * (cph - cpl) + lo['e1'] * (cml - cmh)
             for cpl, cml, cph, cmh in zip(cp_lo, cm_lo, cp_hi, cm_hi)]
        return A, B, C, D

    def even_row(lo, hi, cm_lo, cp_lo, cm_hi, cp_hi):
        """Row 2n+1 for layer n = lo from layers lo and hi = n+1."""
        A = (lo['e1'] + lo['e3']) * (hi['gama'] - 1.0)
        B = (lo['e2'] + lo['e4']) * (hi['gama'] - 1.0)
        C = 2.0 * (1.0 - hi['gama'] ** 2)
        D = [(hi['gama'] - 1.0) * (cph - cpl) + (1.0 - hi['gama']) * (cml - cmh)
             for cpl, cml, cph, cmh in zip(cp_lo, cm_lo, cp_hi, cm_hi)]
        return A, B, C, D

    def eliminate(A, B, C, D, as_next, ds_next):
        x = 1.0 / (B - C * as_next)
        return A * x, [(d - C * ds) * x for d, ds in zip(D, ds_next)]

    def solver_state(L, cps, cms, as_, ds):
        """What the row above needs of layer k+1."""
        return dict(gama=L['gama'], cp=cps, cm=cms, as_=as_, ds=ds)

    def bottom_boundary(L, cp_dn, cm_dn, b_surface):
        A = L['e1'] - surf * L['e3']
        B = L['e2'] - surf * L['e4']
        D = [bs - cpd + surf * cmd
             for bs, cpd, cmd in zip(b_surface, cp_dn, cm_dn)]
        return A / B, [d / B for d in D]

    def step_up(k, hi, L, cp_dn, cm_dn, prefix):
        """Eliminate rows 2(k+1) and 2k+1 given layer k (L) and the
        carried state of layer k+1 (hi)."""
        A, B, C, D = odd_row(L, hi, cm_dn, cp_dn, hi['cm'], hi['cp'])
        as_o, ds_o = eliminate(A, B, C, D, hi['as_'], hi['ds'])
        wr(k + 1, prefix + 'aso', as_o)
        A, B, C, D = even_row(L, hi, cm_dn, cp_dn, hi['cm'], hi['cp'])
        as_e, ds_e = eliminate(A, B, C, D, as_o, ds_o)
        wr(k, prefix + 'ase', as_e)
        for j, (d_o, d_e) in enumerate(zip(ds_o, ds_e)):
            wr(k + 1, f'{prefix}dso{j}', d_o)
            wr(k, f'{prefix}dse{j}', d_e)
        return as_e, ds_e

    def layer_states(n):
        o = optics(n)
        st = {}
        if reflected:
            st['r'] = refl_layer(o, rd(n, 'tau'))
        if thermal:
            st['t'] = therm_layer(o, n)
        return o, st

    nl1 = nlayer - 1
    carry0 = {}
    o_last, st = layer_states(nl1)
    if reflected:
        L, beams = st['r']
        b_surf = [surf * u0 * F0PI * jnp.exp(-tau_total / u0) for u0 in u0s]
        as_, ds = bottom_boundary(L, [b['cpd'] for b in beams],
                                  [b['cmd'] for b in beams], b_surf)
        wr(nl1, 'r_ase', as_)
        for a in range(nang):
            wr(nl1, f'r_dse{a}', ds[a])
        carry0['r'] = solver_state(L, [b['cpu'] for b in beams],
                                   [b['cmu'] for b in beams], as_, ds)
    if thermal:
        T = st['t']
        if hard_surface:
            b_surf = (1.0 - surf) * load(allb_ref, nlayer) * PI
        else:
            b_surf = (load(allb_ref, nlayer) + T['b1'] * _MU1) * PI
        as_, ds = bottom_boundary(T, [T['cpd']], [T['cmd']], [b_surf])
        wr(nl1, 't_ase', as_)
        wr(nl1, 't_dse0', ds[0])
        carry0['t'] = solver_state(T, [T['cpu']], [T['cmu']], as_, ds)

    def up(i, carry):
        k = nlayer - 2 - i
        _, st = layer_states(k)
        new = {}
        if reflected:
            L, beams = st['r']
            as_e, ds_e = step_up(k, carry['r'], L,
                                 [b['cpd'] for b in beams],
                                 [b['cmd'] for b in beams], 'r_')
            new['r'] = solver_state(L, [b['cpu'] for b in beams],
                                    [b['cmu'] for b in beams], as_e, ds_e)
        if thermal:
            T = st['t']
            as_e, ds_e = step_up(k, carry['t'], T, [T['cpd']], [T['cmd']],
                                 't_')
            new['t'] = solver_state(T, [T['cpu']], [T['cmu']], as_e, ds_e)
        return new

    top = jax.lax.fori_loop(0, nlayer - 1, up, carry0)

    # row 0, the top boundary: A = 0, B = gama + 1, C = gama - 1
    def top_boundary(hi, b_top, prefix):
        B = hi['gama'] + 1.0
        C = hi['gama'] - 1.0
        D = [b_top - cm for cm in hi['cm']]
        _, ds = eliminate(jnp.zeros_like(B), B, C, D, hi['as_'], hi['ds'])
        wr(0, prefix + 'aso', jnp.zeros_like(B))
        for j, d in enumerate(ds):
            wr(0, f'{prefix}dso{j}', d)

    if reflected:
        top_boundary(top['r'], 0.0, 'r_')
    if thermal:
        o0 = optics(0)
        tau_top = o0['dtau_og'] * ptfac
        b_top_t = (1.0 - jnp.exp(-tau_top / _MU1)) * load(allb_ref, 0) * PI
        top_boundary(top['t'], b_top_t, 't_')
    sync()

    # -- pass 3, top -> bottom: substitution, sources, TOA sums ---------
    def refl_sources(o, L, beams, tau_og, pos, neg):
        srcs, trans_all = [], []
        for a in range(nang):
            u0, u1 = u0s[a], u1s[a]
            b = beams[a]
            multi_plus, multi_minus = _multi_phase(
                controls, o['ftau_cld'], o['cosb'], o['gcos2'], u1)
            G = (pos[a] * (multi_plus + L['gama'] * multi_minus) * o['w0']
                 * (0.5 / PI))
            H = (neg[a] * (L['gama'] * multi_plus + multi_minus) * o['w0']
                 * (0.5 / PI))
            A_ = ((multi_plus * b['cpu'] + multi_minus * b['cmu']) * o['w0']
                  * (0.5 / PI))
            trans = jnp.exp(-o['dtau'] / u1)
            ssterm = ((o['w0_og'] * F0PI / (4.0 * PI)) * L['p_single']
                      * jnp.exp(-tau_og / u0)
                      * (1.0 - jnp.exp(-o['dtau_og'] * (u0 + u1) / (u0 * u1)))
                      * (u0 / (u0 + u1)))
            den_u1 = L['lamda'] * u1 - 1.0
            hdt1 = o['dtau'] / u1
            x1 = hdt1 * den_u1
            msterm = (A_ * (1.0 - b['e_u0dt'] * trans) * (u0 / (u0 + u1))
                      + G * _resonant_ratio(
                          L['ep'] * trans - 1.0, den_u1,
                          hdt1 * (1.0 + x1 * (0.5 + x1 / 6.0)))
                      + H * (1.0 - L['em'] * trans)
                      / (L['lamda'] * u1 + 1.0))
            srcs.append(ssterm + msterm)
            trans_all.append(trans)
        return srcs, trans_all

    def therm_sources(T, pos, neg, first):
        G = (1.0 / _MU1 - T['lamda']) * pos
        H = T['gama'] * (T['lamda'] + 1.0 / _MU1) * neg
        alpha1 = 2.0 * PI * (T['b0'] + T['b1'] * (T['g1_plus_g2'] - _MU1))
        alpha2 = 2.0 * PI * T['b1']
        dtau = T['dtau']
        out = []
        if first:
            ep_mdpt = jnp.exp(0.5 * T['exptrm'])
            em_mdpt = 1.0 / ep_mdpt
        for iubar in u1s:
            t_mid = jnp.exp(-0.5 * dtau / iubar)
            t_full = t_mid * t_mid
            den = T['lamda'] * iubar - 1.0
            hdt = dtau / iubar
            xden = hdt * den
            if first:
                # the TOA flux is the midpoint flux of layer 0
                s = (G * _resonant_ratio(
                         T['ep'] * t_mid - ep_mdpt, den,
                         ep_mdpt * 0.5 * hdt
                         * (1.0 + 0.25 * xden + xden * xden / 24.0))
                     - H / (T['lamda'] * iubar + 1.0)
                     * (T['em'] * t_mid - em_mdpt)
                     + alpha1 * (1.0 - t_mid)
                     + alpha2 * (iubar + 0.5 * dtau - (dtau + iubar) * t_mid))
                out.append((s, t_mid))
            else:
                s = (G * _resonant_ratio(
                         T['ep'] * t_full - 1.0, den,
                         hdt * (1.0 + xden * (0.5 + xden / 6.0)))
                     + H / (T['lamda'] * iubar + 1.0)
                     * (1.0 - T['em'] * t_full)
                     + alpha1 * (1.0 - t_full)
                     + alpha2 * (iubar - (dtau + iubar) * t_full))
                out.append((s, t_full))
        return out

    def down(n, carry, first=False):
        o = optics(n)
        new = {}
        if reflected:
            tau = rd(n, 'tau')
            L, beams = refl_layer(o, tau)
            L['p_single'] = _single_phase(controls, o['cosb_og'],
                                          o['ftau_cld'], o['ftau_ray'],
                                          o['gcos2'], cos_theta)
            aso, ase = rd(n, 'r_aso'), rd(n, 'r_ase')
            c = carry['r']
            x_o = [rd(n, f'r_dso{a}') - aso * c['x'][a] for a in range(nang)]
            x_e = [rd(n, f'r_dse{a}') - ase * x_o[a] for a in range(nang)]
            pos = [xo + xe for xo, xe in zip(x_o, x_e)]
            neg = [xo - xe for xo, xe in zip(x_o, x_e)]
            srcs, trans = refl_sources(o, L, beams, c['tau_og'], pos, neg)
            new['r'] = dict(
                x=x_e, tau_og=c['tau_og'] + o['dtau_og'],
                acc=[acc + t * s for acc, t, s in zip(c['acc'], c['T'],
                                                      srcs)],
                T=[t * tr for t, tr in zip(c['T'], trans)],
                # bottom flux of this layer; the last one seeds the sweep
                fz=[p * L['ep'] + L['gama'] * q * L['em'] + b['cpd']
                    for p, q, b in zip(pos, neg, beams)])
        if thermal:
            T = therm_layer(o, n)
            c = carry['t']
            x_o = rd(n, 't_dso0') - rd(n, 't_aso') * c['x']
            x_e = rd(n, 't_dse0') - rd(n, 't_ase') * x_o
            st = therm_sources(T, x_o + x_e, x_o - x_e, first)
            if first:
                acc = [s for s, _ in st]
                Tr = [t for _, t in st]
            else:
                acc = [a + t * s for a, t, (s, _) in zip(c['acc'], c['T'],
                                                         st)]
                Tr = [t * tt for t, (_, tt) in zip(c['T'], st)]
            new['t'] = dict(x=x_e, acc=acc, T=Tr)
        return new

    zero = jnp.zeros_like(surf)
    one = jnp.ones_like(surf)
    carry = {}
    if reflected:
        carry['r'] = dict(x=[zero] * nang, tau_og=zero, acc=[zero] * nang,
                          T=[one] * nang, fz=[zero] * nang)
    if thermal:
        carry['t'] = dict(x=zero, acc=[zero] * nang, T=[one] * nang)
    carry = down(0, carry, first=True)
    carry = jax.lax.fori_loop(1, nlayer, down, carry)

    if reflected:
        c = carry['r']
        for a in range(nang):
            store(xint_ref, a, c['acc'][a] + c['T'][a] * (c['fz'][a] / PI))
    if thermal:
        c = carry['t']
        b_bot = load(allb_ref, nlayer)
        if not hard_surface:
            b1_last = (b_bot - load(allb_ref, nl1)) / o_last['dtau_og']
        for a in range(nang):
            if hard_surface:
                fplus_bottom = (1.0 - surf) * b_bot * 2.0 * PI
            else:
                fplus_bottom = (b_bot + b1_last * u1s[a]) * 2.0 * PI
            store(therm_ref, a, c['acc'][a] + c['T'][a] * fplus_bottom)


@partial(jax.jit, static_argnames=('controls', 'stream', 'delta_eddington',
                                   'hard_surface', 'reflected', 'thermal',
                                   'interpret'))
def toon_spectrum(taugas, tauray, cld_opd, cld_w0, cld_g0, rf, all_b, ptfac,
                  surf_reflect, ubar0, ubar1, cos_theta, F0PI, *,
                  controls: ScatteringControls = ScatteringControls(),
                  stream: int = 2, delta_eddington: bool = True,
                  hard_surface: bool = False, reflected: bool = True,
                  thermal: bool = True, interpret: bool = False):
    """TOA reflected intensity and thermal flux from per-source inputs.

    ``taugas``/``tauray``/``cld_*``/``rf`` are [nlayer, nwno],
    ``all_b`` the level Planck function [nlevel, nwno] (used when
    ``thermal``), ``ptfac`` the scalar p0/(p1-p0) of the fake boundary
    above the model (fluxes.py:1797-1800).  Returns ``(xint, flux_top)``,
    each [ng, nt, nwno] or None for a pass not asked for: the contract of
    ``combine_optics`` + ``toon.reflected_1d(get_toa_intensity=True)``
    and ``toon.thermal_1d(...)[0]`` on the OG fields.
    """
    ng, nt = ubar0.shape
    nang = ng * nt
    nlayer, nwno = taugas.shape
    dtype = taugas.dtype
    _, nrec = _records(nang, reflected, thermal)

    out_shape = []
    if reflected:
        out_shape.append(jax.ShapeDtypeStruct((nang, nwno), dtype))
    if thermal:
        out_shape.append(jax.ShapeDtypeStruct((nang, nwno), dtype))
    out_shape.append(jax.ShapeDtypeStruct((nlayer * nrec, nwno), dtype))

    kernel = partial(_kernel, nlayer=nlayer, nwno=nwno, nang=nang,
                     controls=controls, stream=int(stream),
                     delta_eddington=bool(delta_eddington),
                     hard_surface=bool(hard_surface),
                     reflected=bool(reflected), thermal=bool(thermal),
                     interpret=interpret)
    outs = pl.pallas_call(
        kernel,
        grid=(pl.cdiv(nwno, BLOCK),),
        out_shape=out_shape,
        backend='triton',
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=NUM_STAGES),
        interpret=interpret,
        name='toon_spectrum',
    )(ubar0.reshape(-1).astype(dtype), ubar1.reshape(-1).astype(dtype),
      jnp.stack([jnp.asarray(cos_theta, dtype), jnp.asarray(ptfac, dtype)]),
      jnp.stack([jnp.broadcast_to(surf_reflect, (nwno,)),
                 jnp.broadcast_to(F0PI, (nwno,))]).astype(dtype),
      *(x.astype(dtype) for x in (taugas, tauray, cld_opd, cld_w0, cld_g0,
                                  rf, all_b)))
    outs = list(outs[:-1])
    xint = outs.pop(0).reshape(ng, nt, nwno) if reflected else None
    flux_top = outs.pop(0).reshape(ng, nt, nwno) if thermal else None
    return xint, flux_top
