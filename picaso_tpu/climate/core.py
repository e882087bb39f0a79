"""Radiative-convective equilibrium core: fluxes, profile reconstruction,
and the Newton-Raphson flux-zeroing solver.

Device-first redesign of the reference climate internals (climate.py:805-1553
``t_start``, :1687-1952 ``get_fluxes``):

* the correlated-k gauss loop and the disk angles are vmapped axes of one
  jitted flux program;
* the Jacobian — which the reference builds from ~nlevel *serial* full RT
  re-runs per Newton iteration (climate.py:1106-1250, the dominant cost) —
  is ONE batched thermal-RT call vmapped over all perturbation columns;
* convective-zone bookkeeping (the nstr vectors) enters as traced index
  arrays and masks, so zone growth in find_strat never recompiles.

Numerical conventions preserved: del_t = max(1e-4 T, 3 K) finite
differences with opacities held fixed, reverse-order Thomas solves, the
reference's step-max scaling, cubic-backtracking line search, and
tolf/tolx/tolmin tests (Numerical Recipes lnsrch semantics).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..optics import RTProps
from ..rt import toon
from .. import disco as disco_mod
from .adiabat import AdiabatGrid, did_grad_cp

__all__ = ['ClimateGeometry', 'ZoneMaps', 'zone_maps', 'reconstruct_profile',
           'climate_fluxes', 'thermal_fluxes', 'tidal_flux', 'chapman',
           't_start']

SIGMA_SB = 0.56687e-4  # value baked into climate.py:5130


class ClimateGeometry(NamedTuple):
    """Disk angles for climate fluxes (5-node half-sphere, nt=1)."""
    ubar1: jnp.ndarray      # [ng, 1] thermal outgoing angles
    gweight: jnp.ndarray
    tweight: jnp.ndarray


def make_climate_geometry() -> ClimateGeometry:
    geom = disco_mod.make_geometry(0.0, num_gangle=10, num_tangle=1)
    return ClimateGeometry(ubar1=jnp.asarray(geom.ubar1),
                           gweight=jnp.asarray(geom.gweight),
                           tweight=jnp.asarray(geom.tweight))


def chapman(pressure, pm, hratio):
    """Chapman deposition shape exp(1 + h·ln(p/pm) - (p/pm)^h).

    Port of fluxes.py:3732-3751; peaks at p = pm, width set by the
    scale-height ratio ``hratio``.
    """
    x = np.asarray(pressure, float) / pm
    return np.exp(1.0 + hratio * np.log(x) - x ** hratio)


def tidal_flux(teff, nlevel, pressure=None, colden=None, injection=None):
    """Level energy-balance sink/source profile [erg/cm^2/s].

    Port of fluxes.py:3671-3729: the -sigma Teff^4 internal-heat sink
    plus optional energy injection, either a Chapman-function deposition
    (``injection['total_energy']`` erg/cm^2/s peaking at
    ``injection['press_max']`` bar with scale-height ratio
    ``injection['hratio']``) or a user beam profile
    (``injection['beam_profile']`` per level, used when
    ``injection['inject_beam']``).  The cumulative deposition is
    normalized so exactly total_energy crosses the column.
    """
    tide = -SIGMA_SB * teff ** 4
    if not injection:
        return np.zeros(nlevel) + tide
    incr = np.zeros(nlevel)
    if injection.get('inject_beam'):
        beam = np.asarray(injection['beam_profile'], float)
        incr[2:] = -beam[2:nlevel]
        e_tot = float(np.sum(beam))
    else:
        incr[2:] = -(chapman(np.asarray(pressure)[2:],
                             injection['press_max'], injection['hratio'])
                     * np.asarray(colden)[1:nlevel - 1])
        e_tot = float(injection['total_energy'])
    cum = np.cumsum(incr)
    t_tot = cum[-1]
    return cum * e_tot / t_tot + tide - cum[-1] * e_tot / t_tot


# ---------------------------------------------------------------------------
# convective-zone index bookkeeping
# ---------------------------------------------------------------------------

class ZoneMaps(NamedTuple):
    """Traced index arrays derived from (nstr, nofczns); padded to nlevel.

    pert_levels[k]  : level perturbed for Newton column k (or -1 pad)
    resid_level[k]  : flux index for residual k
    resid_is_level[k]: True -> level net flux, False -> layer/midpt net flux
    n_total         : number of active residuals/columns
    is_conv[j]      : level j follows the adiabat from level j-1
    """
    pert_levels: jnp.ndarray
    resid_level: jnp.ndarray
    resid_is_level: jnp.ndarray
    n_total: jnp.ndarray
    is_conv: jnp.ndarray


def zone_maps(nstr, nofczns, nlevel) -> ZoneMaps:
    """Build ZoneMaps on the host from the reference nstr convention.

    nstr = [top_of_atm, top_conv1, bot_conv1, top_rad2, top_conv2,
    bot_conv2]; residual packing follows climate.py:1005-1052 and
    perturbation columns climate.py:1094-1115.
    """
    nstr = [int(i) for i in nstr]
    pert, rlev, risl = [], [], []
    # zone 1 (reaches the top of the atmosphere)
    pert += list(range(nstr[0], nstr[1] + 1))
    rlev += [nstr[0]] + list(range(nstr[0], nstr[1]))
    risl += [True] + [False] * (nstr[1] - nstr[0])
    if nofczns == 2:
        pert += list(range(nstr[3] + 1, nstr[4] + 1))
        rlev += list(range(nstr[3], nstr[4]))
        risl += [False] * (nstr[4] - nstr[3])
    n_total = len(pert)

    is_conv = np.zeros(nlevel, bool)
    is_conv[nstr[1] + 1: nstr[2] + 2] = True
    if nofczns == 2:
        is_conv[nstr[4] + 1: nstr[5] + 2] = True

    def pad(x, fill):
        out = np.full(nlevel, fill, np.int32)
        out[:len(x)] = x
        return out

    return ZoneMaps(
        pert_levels=jnp.asarray(pad(pert, 0)),
        resid_level=jnp.asarray(pad(rlev, 0)),
        resid_is_level=jnp.asarray(pad(np.asarray(risl, np.int32), 0)),
        n_total=jnp.asarray(n_total, jnp.int32),
        is_conv=jnp.asarray(is_conv))


def reconstruct_profile(beta, zones: ZoneMaps, plevel, adiabat: AdiabatGrid,
                        pconv=1e6, moist_args=None):
    """Radiative levels take beta; convective levels follow the adiabat.

    Scan version of climate.py:1122-1152: t[j] = exp(ln t[j-1] +
    grad(t[j-1], sqrt(p[j-1] p[j])) dlnp) inside convective zones.
    With ``moist_args = (cond_abunds [nlayer, ncond], condensables,
    weights)`` the gradient is the moist adiabat (climate.py:1147-1150).
    """
    p_bar = plevel / pconv
    p_mid = jnp.sqrt(p_bar[:-1] * p_bar[1:])
    dlnp = jnp.log(p_bar[1:]) - jnp.log(p_bar[:-1])
    if moist_args is not None:
        from .moist import moist_grad
        cond_abunds, condensables, weights = moist_args
        xs_abunds = cond_abunds
    else:
        xs_abunds = jnp.zeros((p_mid.shape[0], 1), beta.dtype)

    def step(t_prev, row):
        beta_j, conv_j, pm, dl, qc = row
        if moist_args is not None:
            grad_x, _ = moist_grad(t_prev, pm, adiabat, qc, condensables,
                                   weights)
        else:
            grad_x, _ = did_grad_cp(t_prev, pm, adiabat)
        t_ad = jnp.exp(jnp.log(t_prev) + grad_x * dl)
        t_j = jnp.where(conv_j, t_ad, beta_j)
        return t_j, t_j

    _, t_rest = jax.lax.scan(step, beta[0],
                             (beta[1:], zones.is_conv[1:], p_mid, dlnp,
                              xs_abunds))
    return jnp.concatenate([beta[:1], t_rest])


# ---------------------------------------------------------------------------
# climate fluxes
# ---------------------------------------------------------------------------

def thermal_fluxes(tlevel, props: RTProps, plevel, geom: ClimateGeometry,
                   wno, dwno, gauss_wts, surf_reflect):
    """IR net fluxes: (flux_net_ir [nlevel], flux_net_ir_layer [nlevel],
    flux_plus_ir_top [nwno]).

    vmapped over the CK gauss axis; bin-integrated blackbody sources
    (calc_type=1); disk-compressed then summed over bins with dwni
    (climate.py:1873-1942).
    """
    def one_gauss(p: RTProps):
        _, lvl = toon.thermal_1d(tlevel, p.dtau_og, p.w0_no_raman,
                                 p.cosb_og, plevel, geom.ubar1,
                                 surf_reflect, wno, dwno=dwno,
                                 hard_surface=False, calc_type=1)
        return lvl

    lvl = jax.vmap(one_gauss)(props)
    # weight-sum the gauss axis: [ngauss, ng, nt, nlevel, nwno]
    w = gauss_wts[:, None, None, None, None]
    flux_plus = (lvl.plus * w).sum(0)
    flux_minus = (lvl.minus * w).sum(0)
    flux_plus_mid = (lvl.plus_mdpt * w).sum(0)
    flux_minus_mid = (lvl.minus_mdpt * w).sum(0)

    fp = disco_mod.compress_thermal(flux_plus, geom.gweight, geom.tweight)
    fm = disco_mod.compress_thermal(flux_minus, geom.gweight, geom.tweight)
    fpm = disco_mod.compress_thermal(flux_plus_mid, geom.gweight,
                                     geom.tweight)
    fmm = disco_mod.compress_thermal(flux_minus_mid, geom.gweight,
                                     geom.tweight)

    flux_net_ir = ((fp - fm) * dwno[None, :]).sum(-1)
    flux_net_ir_layer = ((fpm - fmm) * dwno[None, :]).sum(-1)
    flux_plus_ir_top = fp[0] * dwno
    return flux_net_ir, flux_net_ir_layer, flux_plus_ir_top


def visible_fluxes(props: RTProps, plevel, F0PI, gauss_wts, surf_reflect,
                   controls: toon.ScatteringControls):
    """Reflected net fluxes at the climate angle ubar0=ubar1=0.5
    (climate.py:1795-1868).  Returns (flux_net_v [nlevel],
    flux_net_v_layer [nlevel]) — summed over bins WITHOUT dwni because the
    climate stellar flux is already bin-integrated (justdoit.py:1843-1879).
    """
    ubar = jnp.full((1, 1), 0.5)

    def one_gauss(p: RTProps):
        _, lvl = toon.reflected_1d(
            p.dtau, p.tau, p.w0, p.cosb, p.gcos2, p.ftau_cld, p.ftau_ray,
            p.dtau_og, p.tau_og, p.w0_og, p.cosb_og, surf_reflect,
            ubar, ubar, 1.0, F0PI, controls=controls,
            get_toa_intensity=False, get_lvl_flux=True)
        return lvl

    lvl = jax.vmap(one_gauss)(props)
    w = gauss_wts[:, None, None, None, None]
    net_layer = (((lvl.plus_mdpt - lvl.minus_mdpt) * w).sum(0)
                 )[0, 0].sum(-1)
    net_level = (((lvl.plus - lvl.minus) * w).sum(0))[0, 0].sum(-1)
    return net_level, net_layer


def climate_fluxes(tlevel, props, plevel, geom, wno, dwno, gauss_wts,
                   surf_reflect, F0PI, controls, compute_reflected):
    """Full get_fluxes equivalent; returns the namedtuple-ish dict."""
    fni, fnil, fpit = thermal_fluxes(tlevel, props, plevel, geom, wno, dwno,
                                     gauss_wts, surf_reflect)
    if compute_reflected:
        fnv, fnvl = visible_fluxes(props, plevel, F0PI, gauss_wts,
                                   surf_reflect, controls)
    else:
        fnv = jnp.zeros_like(fni)
        fnvl = jnp.zeros_like(fni)
    return fni, fnil, fpit, fnv, fnvl


# ---------------------------------------------------------------------------
# the Newton solver (t_start)
# ---------------------------------------------------------------------------

def _pack_residual(flux_net, flux_net_midpt, zones: ZoneMaps):
    """f_vec [nlevel-padded] per the reference packing (climate.py:1005-52)."""
    lev = flux_net[zones.resid_level]
    mid = flux_net_midpt[zones.resid_level]
    vals = jnp.where(zones.resid_is_level.astype(bool), lev, mid)
    k = jnp.arange(vals.shape[0])
    return jnp.where(k < zones.n_total, vals, 0.0)


@partial(jax.jit, static_argnames=('compute_reflected', 'controls_tuple'))
def _flux_state(temp, props, plevel, geom, wno, dwno, gauss_wts,
                surf_reflect, F0PI, controls_tuple, zones, rfaci, rfacv,
                tidal, compute_reflected, fnv_fixed=None, fnvl_fixed=None):
    """``fnv_fixed``/``fnvl_fixed``: with fixed optical properties the
    visible (reflected-stellar) fluxes are temperature-independent, so
    Newton trial states reuse the ones computed at t_start entry instead
    of re-running (or worse, DROPPING) the reflected pass — matching the
    reference's carried flux_net_v (climate.py:1425-1427)."""
    controls = toon.ScatteringControls(*controls_tuple)
    fni, fnil, fpit, fnv, fnvl = climate_fluxes(
        temp, props, plevel, geom, wno, dwno, gauss_wts, surf_reflect,
        F0PI, controls, compute_reflected)
    if fnv_fixed is not None:
        fnv, fnvl = fnv_fixed, fnvl_fixed
    flux_net = rfaci * fni + rfacv * fnv + tidal
    flux_net_mid = rfaci * fnil + rfacv * fnvl + tidal
    f_vec = _pack_residual(flux_net, flux_net_mid, zones)
    return dict(flux_net_ir=fni, flux_net_ir_layer=fnil,
                flux_plus_ir_top=fpit, flux_net_v=fnv, flux_net_v_layer=fnvl,
                f_vec=f_vec)


@jax.jit
def _jacobian(beta, temp_old, flux_ir_old, flux_ir_layer_old, zones,
              props, plevel, geom, wno, dwno, gauss_wts, surf_reflect,
              adiabat):
    """A[k, m] = d resid_k / d T_pert_m by batched finite differences.

    One vmapped thermal-RT call over all perturbation columns (vs the
    reference's serial nlevel re-runs, climate.py:1106-1250).
    """
    nlevel = beta.shape[0]
    eps = 1e-4

    def one_column(m):
        jm = zones.pert_levels[m]
        del_t = jnp.maximum(eps * temp_old[jm], 3.0)
        beta_p = beta.at[jm].add(del_t)
        temp_p = reconstruct_profile(beta_p, zones, plevel, adiabat)
        fni, fnil, _ = thermal_fluxes(temp_p, props, plevel, geom, wno,
                                      dwno, gauss_wts, surf_reflect)
        dlev = (fni[zones.resid_level] - flux_ir_old[zones.resid_level])
        dmid = (fnil[zones.resid_level]
                - flux_ir_layer_old[zones.resid_level])
        col = jnp.where(zones.resid_is_level.astype(bool), dlev, dmid)
        return col / del_t

    # sequential-chunked map keeps the batched RT intermediates bounded in
    # HBM (a full vmap would materialize ~nlevel x ngauss x nangle x nwno)
    A = jax.lax.map(one_column, jnp.arange(nlevel), batch_size=8).T
    k = jnp.arange(nlevel)
    active = (k < zones.n_total)
    mask2d = active[:, None] & active[None, :]
    eye = jnp.eye(nlevel, dtype=A.dtype)
    return jnp.where(mask2d, A, eye)


@jax.jit
def _apply_step(beta, p_step, alam, zones, plevel, adiabat, tmin, tmax):
    """temp_rad = beta + alam*p on perturbed levels; adiabat re-stitch;
    tmin/tmax clamp (climate.py:1364-1392)."""
    nlevel = beta.shape[0]
    k = jnp.arange(nlevel)
    active = k < zones.n_total
    add = jnp.zeros_like(beta).at[zones.pert_levels].add(
        jnp.where(active, alam * p_step, 0.0))
    beta_new = beta + add
    temp = reconstruct_profile(beta_new, zones, plevel, adiabat)
    return jnp.clip(temp, tmin + 0.1, tmax - 0.1)


@dataclasses.dataclass
class TStartResult:
    temp: np.ndarray
    dtdp: np.ndarray
    converged: bool
    flux_net_ir: np.ndarray
    flux_net_v: np.ndarray
    flux_plus_ir_top: np.ndarray
    profiles: list


def t_start(temp, plevel, nstr, nofczns, props: RTProps,
            geom: ClimateGeometry, wno, dwno, gauss_wts, surf_reflect,
            F0PI, controls: toon.ScatteringControls, adiabat: AdiabatGrid,
            rfaci, rfacv, tidal, tmin, tmax, it_max=10, conv=5.0,
            x_max_mult=7.0, egp_stepmax=False, verbose=False,
            save_profiles=False) -> TStartResult:
    """Newton-Raphson T(P) solve with fixed opacities (climate.py:805-1553).

    Host drives scalar control flow; every array op (fluxes, the batched
    Jacobian, profile reconstruction, line-search trials) is jitted device
    work.
    """
    nlevel = len(temp)
    zones = zone_maps(nstr, nofczns, nlevel)
    n_total = int(zones.n_total)
    controls_tuple = tuple(dataclasses.astuple(controls))
    compute_reflected = rfacv != 0.0

    tidal = jnp.asarray(tidal)
    temp = jnp.asarray(temp)
    plevel = jnp.asarray(plevel)

    # numerical-recipes knobs (climate.py:905-912)
    alf, tolmin, tolf, tolx = 1e-4, 1e-5, 5e-3, 5e-3
    step_max = 0.01        # compounds across iterations (climate.py:907)

    profiles = []
    state = _flux_state(temp, props, plevel, geom, wno, dwno, gauss_wts,
                        surf_reflect, F0PI, controls_tuple, zones, rfaci,
                        rfacv, tidal, compute_reflected)
    # visible fluxes are fixed for fixed props: computed once, carried
    # through every Newton trial (reference climate.py:1425-1427)
    flux_v_fixed = state['flux_net_v']
    flux_v_layer_fixed = state['flux_net_v_layer']

    converged = False
    for its in range(it_max):
        f_vec = np.asarray(state['f_vec'])[:n_total]
        temp_old = np.asarray(temp)
        flux_ir_old = state['flux_net_ir']
        flux_ir_layer_old = state['flux_net_ir_layer']

        ssum = float((f_vec ** 2).sum())
        sum_1 = float((temp_old[:n_total] ** 2).sum())
        test = float(np.abs(f_vec).max())
        f = 0.5 * ssum

        if test / abs(float(tidal[0])) < 0.01 * tolf:
            converged = True
            break

        if egp_stepmax:
            step_max = 0.005 * max(np.sqrt(sum_1), n_total * 1.0)
        else:
            # NOTE the reference COMPOUNDS step_max across Newton
            # iterations (climate.py:907 initial 0.01, then :1082
            # `step_max *= ...` each pass) — after ~2 iterations the
            # clamp is effectively unbounded and the solver takes full
            # Newton steps.  Deliberate quirk; preserved for trace
            # parity (tests/test_reference_parity.py).
            iteration_factor = max(0.01, (it_max - its) / it_max)
            step_max = (step_max * max(np.sqrt(sum_1), n_total * 1.0)
                        * iteration_factor)

        A = _jacobian(temp, jnp.asarray(temp_old), flux_ir_old,
                      flux_ir_layer_old, zones, props, plevel, geom, wno,
                      dwno, gauss_wts, surf_reflect, adiabat)
        A_np = np.asarray(A)[:n_total, :n_total]
        g = A_np.T @ f_vec
        try:
            p_step = np.linalg.solve(A_np, -f_vec)
        except np.linalg.LinAlgError:
            p_step = -f_vec / np.maximum(np.abs(np.diag(A_np)), 1e-30)

        dflux = f_vec.copy()
        norm = float(np.sqrt((p_step[2:] ** 2).sum()))
        if norm > step_max:
            p_step *= step_max / norm
            dflux = -p_step
        slope = float(g @ p_step)
        test = float(np.max(np.abs(p_step) / temp_old[:n_total]))
        alamin = tolx / test
        alam, alam2, f2 = 1.0, 0.0, f
        f_old = f
        check = False

        beta = temp  # radiative anchor for this Newton iteration
        p_dev = jnp.zeros(nlevel).at[:n_total].set(jnp.asarray(p_step))

        flag_converge = 0
        while flag_converge == 0:
            temp_trial = _apply_step(beta, p_dev, alam, zones, plevel,
                                     adiabat, tmin, tmax)
            state = _flux_state(temp_trial, props, plevel, geom, wno, dwno,
                                gauss_wts, surf_reflect, F0PI,
                                controls_tuple, zones, rfaci, rfacv, tidal,
                                False, fnv_fixed=flux_v_fixed,
                                fnvl_fixed=flux_v_layer_fixed)
            f_vec_new = np.asarray(state['f_vec'])[:n_total]
            f = 0.5 * float((f_vec_new ** 2).sum())

            def _check():
                # check_convergence (climate.py:1555-1631)
                t = float(np.abs(f_vec_new).max())
                if t < tolf:
                    return 2, False
                if check:
                    den1 = max(f, 0.5 * n_total)
                    t2 = float(np.max(g * dflux / den1)) if n_total else 0.0
                    return 2, t2 < tolmin
                tt = np.asarray(temp_trial)[:n_total]
                t3 = float(np.max(np.abs(tt - temp_old[:n_total])
                                  / temp_old[:n_total]))
                if t3 < tolx:
                    return 2, check
                return 1, check

            if alam < alamin:
                check = True
                flag_converge, check = _check()
            elif f <= f_old + alf * alam * slope:
                flag_converge, check = _check()
            else:
                if alam == 1.0:
                    tmplam = -slope / (2 * (f - f_old - slope))
                else:
                    rhs_1 = f - f_old - alam * slope
                    rhs_2 = f2 - f_old - alam2 * slope
                    anr = ((rhs_1 / alam ** 2 - rhs_2 / alam2 ** 2)
                           / (alam - alam2))
                    b = ((-alam2 * rhs_1 / alam ** 2
                          + alam * rhs_2 / alam2 ** 2) / (alam - alam2))
                    if anr == 0:
                        tmplam = -slope / (2.0 * b)
                    else:
                        disc = b * b - 3.0 * anr * slope
                        if disc < 0.0:
                            tmplam = 0.5 * alam
                        elif b <= 0.0:
                            tmplam = (-b + np.sqrt(disc)) / (3.0 * anr)
                        else:
                            tmplam = -slope / (b + np.sqrt(disc))
                    tmplam = min(tmplam, 0.5 * alam)
                alam2, f2 = alam, f
                alam = max(tmplam, 0.1 * alam)
            if np.isnan(np.asarray(temp_trial)).any():
                flag_converge = 1
                temp_trial = jnp.asarray(temp_old + 0.5)

        temp = temp_trial
        if save_profiles:
            profiles.append(temp_old)
        if verbose:
            print(f'  t_start it {its}: Tmin/max '
                  f'{float(jnp.min(temp)):.1f}/{float(jnp.max(temp)):.1f} '
                  f'balance {float(state["f_vec"][0] / abs(tidal[0])):.2e}')
        if flag_converge == 2:
            converged = True
            break

    # recompute visible+ir state for the returned fluxes
    state = _flux_state(temp, props, plevel, geom, wno, dwno, gauss_wts,
                        surf_reflect, F0PI, controls_tuple, zones, rfaci,
                        rfacv, tidal, compute_reflected)
    temp_np = np.asarray(temp)
    dtdp = (np.diff(np.log(temp_np)) / np.diff(np.log(np.asarray(plevel))))
    return TStartResult(
        temp=temp_np, dtdp=dtdp, converged=converged,
        flux_net_ir=np.asarray(state['flux_net_ir_layer']),
        flux_net_v=np.asarray(state['flux_net_v_layer']),
        flux_plus_ir_top=np.asarray(state['flux_plus_ir_top']),
        profiles=profiles)
