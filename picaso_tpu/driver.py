"""TOML-driven spectrum / retrieval runner.

Port of the reference ``driver.py`` against the same TOML schema
(``refdata/input_tomls/driver.toml``): [InputOutput]/[OpticalProperties]/
[object]/[star]/[temperature]/[chemistry]/[clouds] blocks configure the
forward model; [retrieval.*] blocks declare priors over dotted config
paths.  The reference farms dynesty likelihoods to MPI ranks
(driver.py:383-427); here the sampler batch (live points / walkers)
evaluates vectorized through the device forward model, and checkpoint/resume
rides on :func:`picaso_tpu.sampler.nested_sample`.
"""

from __future__ import annotations

import os
import tomllib

import numpy as np
import pandas as pd

from . import justdoit as jdi
from . import units as u
from .parameterizations import Parameterize
from .wavelength import conv_non_uniform_R  # noqa: F401 (driver.py:338)
from .sampler import nested_sample, ensemble_sample

__all__ = ['run', 'load_toml', 'setup_spectrum_class', 'prior_finder',
           'MODEL', 'log_likelihood', 'viz', 'conv_non_uniform_R']


def load_toml(path_or_dict):
    if isinstance(path_or_dict, dict):
        return path_or_dict
    with open(path_or_dict, 'rb') as f:
        return tomllib.load(f)


def _value(entry, default_unit=None):
    """Unpack {value=..., unit=...} TOML entries to CGS-ish floats."""
    if isinstance(entry, dict):
        val = entry['value']
        unit = entry.get('unit', default_unit)
        known = {'Kelvin': 1.0, 'kelvin': 1.0, 'v/v': 1.0, 'radian': 1.0,
                 'bar': 1.0, 'logbar': 1.0, 'parsec': 1.0, 'cm**2/s': 1.0}
        if unit in (None, '') or unit in known:
            return val
        return u.to_cgs(val, unit)
    return entry


def setup_spectrum_class(config, opa=None, params=None):
    """Build an inputs bundle from a TOML config (driver.py:484).

    ``params`` optionally overrides dotted config paths (retrieval step).
    """
    config = _apply_params(config, params) if params else config
    if opa is None:
        op = config.get('OpticalProperties', {})
        opa = jdi.opannection(
            filename_db=op.get('opacity_files'),
            method=op.get('opacity_method', 'resampled'),
            wave_range=op.get('wave_range'),
            **op.get('opacity_kwargs', {}))

    case = jdi.inputs()
    geometry = config.get('geometry', {})
    case.phase_angle(float(_value(geometry.get('phase', 0.0))))

    obj = config.get('object', {})
    if 'radius' in obj and 'mass' in obj:
        case.gravity(radius=obj['radius']['value'],
                     radius_unit=u.Unit(obj['radius']['unit']),
                     mass=obj['mass']['value'],
                     mass_unit=u.Unit(obj['mass']['unit']))
    elif 'gravity' in obj:
        case.gravity(gravity=obj['gravity']['value'],
                     gravity_unit=u.Unit(obj['gravity']['unit']))

    if config.get('irradiated', True) and 'star' in config:
        star = config['star']
        kw = {}
        if 'radius' in star:
            kw.update(radius=star['radius']['value'],
                      radius_unit=u.Unit(star['radius']['unit']))
        if 'semi_major' in star:
            kw.update(semi_major=star['semi_major']['value'],
                      semi_major_unit=u.Unit(star['semi_major']['unit']))
        if star.get('type', 'grid') == 'userfile':
            uf = star['userfile']
            case.star(opa, filename=uf['filename'], w_unit=uf['w_unit'],
                      f_unit=uf['f_unit'], **kw)
        else:
            g = star.get('grid', {})
            case.star(opa, g.get('teff', 5700), g.get('feh', 0.0),
                      g.get('logg', 4.5), **kw)
    else:
        case.setup_nostar()

    # --- temperature structure ---
    temp_cfg = config.get('temperature', {})
    pgrid_cfg = temp_cfg.get('pressure', {})
    nlevel = pgrid_cfg.get('nlevel', 91)
    pmin = float(_value(pgrid_cfg.get('min', 1e-6)))
    pmax = float(_value(pgrid_cfg.get('max', 1e2)))
    pressure = np.logspace(np.log10(pmin), np.log10(pmax), nlevel)
    param = Parameterize(pressure=pressure)
    param.add_class(case)

    profile_kind = temp_cfg.get('profile', 'userfile')
    if profile_kind == 'userfile':
        uf = temp_cfg['userfile']
        df = pd.read_csv(uf['filename'], **uf.get('pd_kwargs',
                                                  {'sep': r'\s+'}))
        case.atmosphere(df=df)
        pressure = np.asarray(df['pressure'])
        param = Parameterize(pressure=pressure)
        param.add_class(case)
        temperature = np.asarray(df['temperature'])
    elif profile_kind == 'isothermal':
        temperature = param.pt_isothermal(temp_cfg['isothermal']['T'])
    elif profile_kind == 'knots':
        k = temp_cfg['knots']
        temperature = param.pt_knots(
            k['P_knots'], k['T_knots'],
            interpolation=k.get('interpolation', 'brewster'))
    elif profile_kind == 'guillot':
        g = temp_cfg['guillot']
        temperature = param.pt_guillot(g['Teq'], g['T_int'], g['logg1'],
                                       g['logKir'], g['alpha'])
    elif profile_kind == 'madhu_seager_09_noinversion':
        m = temp_cfg['madhu_seager_09_noinversion']
        temperature = param.pt_madhu_seager_09_noinversion(
            m['alpha_1'], m['alpha_2'], m['P_1'], m['P_3'], m['T_3'],
            beta=m.get('beta', 0.5))
    elif profile_kind == 'madhu_seager_09_inversion':
        m = temp_cfg['madhu_seager_09_inversion']
        temperature = param.pt_madhu_seager_09_inversion(
            m['alpha_1'], m['alpha_2'], m['P_1'], m['P_2'], m['P_3'],
            m['T_3'], beta=m.get('beta', 0.5))
    elif profile_kind == 'zj_24':
        z = temp_cfg['zj_24']
        temperature = param.pt_zj24(z['pressures'], z['dTs'], z['Tbottom'])
    else:
        raise ValueError(f'unknown temperature profile {profile_kind}')

    # --- chemistry ---
    chem_cfg = config.get('chemistry', {})
    method = chem_cfg.get('method', 'userfile')
    if method == 'free':
        free = dict(chem_cfg.get('free', {}))
        bg = free.pop('background', {'gases': ['H2', 'He'],
                                     'fraction': 5.667})
        species = {}
        for mol, entry in free.items():
            val = np.atleast_1d(_value(entry))
            species[mol] = float(val[0]) if len(val) == 1 else val
        df = param.chem_free(background=tuple(bg['gases']),
                             background_ratio=bg.get('fraction', 5.667),
                             **{m: np.log10(v) if np.all(
                                 np.asarray(v) > 0) else v
                                for m, v in species.items()})
        df['temperature'] = temperature
        case.atmosphere(df=df)
    elif method == 'userfile':
        if profile_kind != 'userfile':
            uf = chem_cfg.get('userfile', temp_cfg.get('userfile'))
            df = pd.read_csv(uf['filename'],
                             **uf.get('pd_kwargs', {'sep': r'\s+'}))
            df['temperature'] = np.interp(
                np.log10(pressure), np.log10(np.asarray(df['pressure'])),
                temperature) if len(df) != len(pressure) else temperature
            case.atmosphere(df=df)
    elif method == 'visscher':
        case.add_pt(temperature, pressure)
        case.premix_atmosphere(opa)
    else:
        raise ValueError(f'unknown chemistry method {method}')

    # --- clouds ---
    cld_cfg = config.get('clouds', {})
    for key in list(cld_cfg):
        if not key.endswith('_type'):
            continue
        cname = key[:-5]
        ctype = cld_cfg[key]
        block = cld_cfg.get(cname, {}).get(ctype, {})
        if ctype == 'hard_grey':
            param.cloud_hard_grey(block.get('g0', 0), block.get('w0', 0),
                                  block.get('opd', 10),
                                  block.get('p', 1), block.get('dp', 1))
        elif ctype == 'brewster_grey':
            kw = (block.get('slab_kwargs', {})
                  if block.get('decay_type') == 'slab'
                  else block.get('deck_kwargs', {}))
            df = param.cloud_brewster_grey(
                block.get('decay_type', 'slab'), block.get('alpha', 0),
                block.get('ssa', 0.99),
                ptop=10.0 ** kw.get('ptop', 0.0), dp=kw.get('dp', 1.0),
                reference_tau=kw.get('reference_tau', 1.0),
                reference_wave=block.get('reference_wave', 1.0))
            case.clouds(df=df)
    return case, opa, param


def _apply_params(config, params):
    """Deep-copy config and set dotted-path overrides.

    Numeric path components index into lists (e.g.
    'temperature.knots.T_knots.0' sets the first temperature knot).
    """
    import copy
    cfg = copy.deepcopy(config)
    for path, val in params.items():
        parts = path.split('.')
        node = cfg
        for p in parts[:-1]:
            if isinstance(node, list):
                node = node[int(p)]
            else:
                node = node.setdefault(p, {})
        leaf = parts[-1]
        if isinstance(node, list):
            node[int(leaf)] = val
        else:
            node[leaf] = val
    return cfg


def prior_finder(config):
    """Collect [retrieval.*] prior declarations -> list of fit parameters.

    Returns list of dicts {path, prior, kwargs, log} where path is the
    dotted config path the sampled value overrides (driver.py:143).
    """
    pri = config.get('retrieval', {})
    out = []

    def walk(node, path):
        if isinstance(node, dict) and 'prior' in node:
            kind = node['prior']
            kwargs = node.get(f'{kind}_kwargs', {})
            out.append(dict(path='.'.join(path), prior=kind,
                            kwargs=kwargs, log=node.get('log', False)))
            return
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + [k])

    walk(pri, [])
    # priors may also live at top level (e.g. [temperature.knots...])
    for blk in ('temperature', 'chemistry', 'clouds', 'object'):
        sub = config.get(blk, {})
        walk_top(sub, [blk], out)
    return out


def walk_top(node, path, out):
    if isinstance(node, dict) and 'prior' in node:
        kind = node['prior']
        out.append(dict(path='.'.join(path), prior=kind,
                        kwargs=node.get(f'{kind}_kwargs', {}),
                        log=node.get('log', False)))
        return
    if isinstance(node, dict):
        for k, v in node.items():
            walk_top(v, path + [k], out)


def prior_transform(fitpars):
    """Unit cube -> parameter space mapping for the declared priors."""
    from scipy.special import ndtri

    def transform(uu):
        uu = np.atleast_2d(uu)
        out = np.zeros_like(uu)
        for i, p in enumerate(fitpars):
            if p['prior'] == 'uniform':
                lo, hi = p['kwargs']['min'], p['kwargs']['max']
                out[:, i] = lo + uu[:, i] * (hi - lo)
            elif p['prior'] == 'gaussian':
                out[:, i] = (p['kwargs']['mean']
                             + p['kwargs']['std'] * ndtri(uu[:, i]))
            else:
                raise ValueError(f"unknown prior {p['prior']}")
        return out

    return transform


def MODEL(theta, config, opa, fitpars, data_wno):
    """Forward model at sampled parameters -> binned spectrum
    (driver.py:176-251)."""
    params = {}
    for val, p in zip(theta, fitpars):
        params[p['path']] = 10 ** val if p['log'] else val
    case, opa, _ = setup_spectrum_class(config, opa=opa, params=params)
    obs_type = config.get('observation_type', 'transmission')
    calc = obs_type.replace('+', '+')
    out = case.spectrum(opa, calculation=calc)
    key = {'transmission': 'transit_depth', 'thermal': 'fpfs_thermal',
           'reflected': 'fpfs_reflected'}[obs_type.split('+')[0]]
    y = out[key]
    if isinstance(y, list):
        y = out.get('thermal', out.get('albedo'))
    from .wavelength import mean_regrid
    _, binned = mean_regrid(out['wavenumber'], np.asarray(y),
                            newx=data_wno)
    return np.nan_to_num(binned, nan=0.0)


def log_likelihood(theta, config, opa, fitpars, data_wno, y, e):
    model = MODEL(theta, config, opa, fitpars, data_wno)
    return -0.5 * np.sum((y - model) ** 2 / e ** 2)


def setup_climate_class(config, opa=None):
    """Build (case, opa) for a TOML climate run.

    The reference driver leaves calc_type='climate' unimplemented
    (driver.py:67-69); this schema drives the full RCE solver from TOML:

    .. code-block:: toml

        calc_type = 'climate'
        [OpticalProperties]
        ck_db = '/path/to/premixed.hdf5'    # or 'legacy_dir/ascii_data'
        opacity_method = 'preweighted'       # or 'resortrebin'
        [object]
        gravity = {value = 100.0, unit = 'm/(s**2)'}
        [climate]
        teff = 700.0
        nlevel = 91
        logp_top = -4.0      # log10 bar
        logp_bottom = 2.5
        rcb_guess = 71       # initial radiative-convective boundary index
        rfacv = 0.0          # stellar-flux weight (0 = isolated object)
        temp_guess = [..]    # optional explicit T(P) guess [nlevel]
        diseq_chem = false   # -> run_kwargs passthrough
        [climate.run_kwargs]
        diseq_chem = false
    """
    cl = config.get('climate', {})
    if opa is None:
        op = config.get('OpticalProperties', {})
        opa = jdi.opannection(
            ck_db=op.get('ck_db'),
            method=op.get('opacity_method', 'preweighted'),
            wave_range=op.get('wave_range'),
            **op.get('opacity_kwargs', {}))

    case = jdi.inputs(calculation=config.get('object_type', 'browndwarf'),
                      climate=True)
    case.phase_angle(float(_value(config.get('geometry',
                                             {}).get('phase', 0.0))))
    obj = config.get('object', {})
    if 'radius' in obj and 'mass' in obj:
        case.gravity(radius=obj['radius']['value'],
                     radius_unit=u.Unit(obj['radius']['unit']),
                     mass=obj['mass']['value'],
                     mass_unit=u.Unit(obj['mass']['unit']))
    elif 'gravity' in obj:
        case.gravity(gravity=obj['gravity']['value'],
                     gravity_unit=u.Unit(obj['gravity']['unit']))
    else:
        raise ValueError('[object] needs gravity or radius+mass')
    case.effective_temp(float(_value(cl.get('teff', 1000.0))))

    if config.get('irradiated', False) and 'star' in config:
        star = config['star']
        g = star.get('grid', {})
        kw = {}
        if 'radius' in star:
            kw.update(radius=star['radius']['value'],
                      radius_unit=u.Unit(star['radius']['unit']))
        if 'semi_major' in star:
            kw.update(semi_major=star['semi_major']['value'],
                      semi_major_unit=u.Unit(star['semi_major']['unit']))
        case.star(opa, g.get('teff', 5700), g.get('feh', 0.0),
                  g.get('logg', 4.5), **kw)
    else:
        case.setup_nostar()
    case.setup_climate()

    nlevel = int(cl.get('nlevel', 91))
    pressure = np.logspace(float(cl.get('logp_top', -4.0)),
                           float(cl.get('logp_bottom', 2.5)), nlevel)
    teff = float(_value(cl.get('teff', 1000.0)))
    if 'temp_guess' in cl:
        guess = np.asarray(cl['temp_guess'], float)
        if len(guess) != nlevel:
            raise ValueError('temp_guess length must equal nlevel')
    else:
        guess = np.clip(teff * 1.2 * (pressure / 30.0) ** 0.1,
                        max(0.25 * teff, 100.0), None)
    case.inputs_climate(
        temp_guess=guess, pressure=pressure,
        rcb_guess=int(cl.get('rcb_guess', nlevel - 20)),
        rfacv=float(cl.get('rfacv', 0.0)),
        rfaci=float(cl.get('rfaci', 1.0)),
        moistgrad=bool(cl.get('moistgrad', False)))
    if cl.get('virga'):
        case.inputs['climate']['cloudy'] = True
        case.inputs['climate']['virga_kwargs'] = dict(cl['virga'])
    return case, opa


def run(toml_input, data=None, sampler='nested', nlive=100, nsteps=300,
        verbose=True, **sampler_kwargs):
    """Top-level driver (driver.py:28-71).

    calc_type='spectrum' -> returns (case, out_dict);
    calc_type='retrieval' -> returns sampler results (data can be passed
    directly as (wlgrid_micron, y, e) instead of via [InputOutput]).
    """
    config = load_toml(toml_input)
    calc_type = config.get('calc_type', 'spectrum')

    if calc_type == 'spectrum':
        case, opa, _ = setup_spectrum_class(config)
        obs = config.get('observation_type', 'thermal')
        out = case.spectrum(opa, calculation=obs)
        return case, out

    if calc_type == 'climate':
        case, opa = setup_climate_class(config)
        out = case.climate(opa, verbose=verbose,
                           **config.get('climate', {}).get('run_kwargs',
                                                           {}))
        return case, out

    # retrieval
    if data is None:
        io_cfg = config['InputOutput']
        df = pd.read_csv(io_cfg['observation_data'])
        wl = np.asarray(df[io_cfg.get('coord_key', 'central_wavelength')])
        y = np.asarray(df[io_cfg['y_key']])
        e = np.asarray(df[io_cfg['error_key']])
    else:
        wl, y, e = data
    data_wno = np.sort(1e4 / np.asarray(wl))
    order = np.argsort(1e4 / np.asarray(wl))
    y = np.asarray(y)[order]
    e = np.asarray(e)[order]

    fitpars = prior_finder(config)
    if not fitpars:
        raise ValueError('no [retrieval.*] priors declared in the config')
    if verbose:
        print('fitting:', [p['path'] for p in fitpars])
    ndim = len(fitpars)
    opa_shared = None
    case0, opa_shared, _ = setup_spectrum_class(config)

    def loglike_batch(thetas):
        return np.array([log_likelihood(t, config, opa_shared, fitpars,
                                        data_wno, y, e) for t in thetas])

    transform = prior_transform(fitpars)

    if sampler == 'nested':
        res = nested_sample(loglike_batch, transform, ndim, nlive=nlive,
                            vectorized=True, verbose=verbose,
                            **sampler_kwargs)
    else:
        rng = np.random.default_rng(0)
        nwalkers = max(2 * ndim + 2, 8)
        nwalkers += nwalkers % 2
        p0 = transform(rng.random((nwalkers, ndim)))
        chain, lps = ensemble_sample(loglike_batch, p0, nsteps,
                                     **sampler_kwargs)
        res = dict(chain=chain, log_probs=lps,
                   samples_equal=chain[nsteps // 2:].reshape(-1, ndim))
    res['fitpars'] = fitpars
    return res


def viz(case, out, savefile=None):
    """One-figure dashboard of a driver spectrum run
    (driver.py:713-741: spectra + PT + mixing ratios + clouds; the
    bokeh dashboard becomes a matplotlib panel grid).

    ``case, out`` are what ``run(..., calc_type='spectrum')`` returns.
    Returns the figure; ``savefile`` writes it (png/pdf).
    """
    import matplotlib.pyplot as plt

    from . import justplotit as jpi

    fig, axes = plt.subplots(2, 2, figsize=(11, 7))
    (ax_spec, ax_pt), (ax_mr, ax_cld) = axes

    wno = np.asarray(out['wavenumber'])
    plotted = False
    for key, lbl in (('albedo', 'albedo'),
                     ('fpfs_thermal', 'Fp/Fs thermal'),
                     ('thermal', 'thermal flux'),
                     ('transit_depth', '(Rp/Rs)^2')):
        if key in out and np.ndim(out[key]) == 1:
            ax_spec.plot(1e4 / wno, np.asarray(out[key]), lw=0.8,
                         label=lbl)
            plotted = True
    if plotted:
        ax_spec.set_xlabel('wavelength [um]')
        ax_spec.legend(fontsize=8)
    ax_spec.set_title('spectrum')

    prof = case.inputs['atmosphere']['profile']
    jpi.pt(pressure=np.asarray(prof['pressure']),
           temperature=np.asarray(prof['temperature']), ax=ax_pt)
    jpi.mixing_ratio(prof, ax=ax_mr)

    cld = case.inputs.get('clouds', {}).get('profile')
    if cld is not None:
        nlayer = len(np.asarray(prof['pressure'])) - 1
        opd = np.asarray(cld['opd']).reshape(nlayer, -1)
        ax_cld.semilogy(opd.sum(axis=1),
                        np.sqrt(np.asarray(prof['pressure'])[1:]
                                * np.asarray(prof['pressure'])[:-1]))
        ax_cld.invert_yaxis()
        ax_cld.set_xlabel('column opd (summed over wavelength)')
        ax_cld.set_ylabel('pressure [bar]')
    ax_cld.set_title('clouds')

    fig.tight_layout()
    if savefile:
        fig.savefig(savefile, dpi=150)
    return fig
