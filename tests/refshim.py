"""Import the reference PICASO (/root/reference) as pure numpy, in-process.

The reference depends on numba, astropy, synphot/stsynphot, virga, bokeh
and xarray — none installed here.  None of them carry numerics that the
1D-spectrum call path actually needs beyond fixed unit conversions, so we
install minimal shims into ``sys.modules`` and import the real reference
package.  With numba shimmed to a no-op decorator, every ``@jit`` kernel in
``fluxes.py`` / ``optics.py`` / ``disco.py`` / ``climate.py`` runs as plain
numpy — byte-for-byte the reference's arithmetic, minus compilation.

This exists solely to power tests/test_reference_parity.py: A/B numerical
comparison of picaso_tpu against the actual reference implementation.
It is test infrastructure, not part of
the picaso_tpu package.
"""

import io
import json
import os
import sys
import types

import numpy as np

REFERENCE_ROOT = '/root/reference'
REFERENCE_REFDATA = os.path.join(REFERENCE_ROOT, 'reference')

_loaded = {}


# ---------------------------------------------------------------------------
# numba
# ---------------------------------------------------------------------------

def _passthrough_decorator(*args, **kwargs):
    if args and callable(args[0]) and len(args) == 1 and not kwargs:
        return args[0]
    return lambda f: f


class _NumbaType:
    """Stands in for numba.float64 etc. — supports float64[:] in specs."""

    def __getitem__(self, item):
        return self

    def __call__(self, *a, **k):
        return self


class _ObjMode:
    def __init__(self, **kwargs):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _make_numba():
    numba = types.ModuleType('numba')
    numba.jit = _passthrough_decorator
    numba.njit = _passthrough_decorator
    numba.vectorize = _passthrough_decorator
    numba.objmode = _ObjMode
    numba.prange = range
    numba.float32 = _NumbaType()
    numba.float64 = _NumbaType()
    numba.int32 = _NumbaType()
    numba.int64 = _NumbaType()
    experimental = types.ModuleType('numba.experimental')
    experimental.jitclass = lambda spec=None: (lambda cls: cls)
    numba.experimental = experimental
    return {'numba': numba, 'numba.experimental': experimental}


# ---------------------------------------------------------------------------
# astropy (units with real CGS math, constants, io.fits, JsonCustomEncoder)
# ---------------------------------------------------------------------------

# unit atoms: name -> factor to CGS base (cm, g, s, K, erg=g cm^2/s^2)
_UNIT_ATOMS = {
    'cm': 1.0, 'm': 100.0, 'km': 1e5, 'um': 1e-4, 'micron': 1e-4,
    'AA': 1e-8, 'Angstrom': 1e-8, 'nm': 1e-7,
    'g': 1.0, 'kg': 1e3,
    's': 1.0, 'h': 3600.0, 'hr': 3600.0, 'day': 86400.0, 'yr': 3.155693e7,
    'K': 1.0,
    'erg': 1.0, 'J': 1e7, 'W': 1e7,
    'Hz': 1.0,
    'bar': 1e6, 'mbar': 1e3, 'Pa': 10.0, 'dyn': 1.0,
    # astropy's own values (CODATA / IAU)
    'au': 1.49597870700e13, 'AU': 1.49597870700e13,
    'pc': 3.0856775814913673e18,
    'R_jup': 7.1492e9, 'Rjup': 7.1492e9,
    'M_jup': 1.8981245973360505e30, 'Mjup': 1.8981245973360505e30,
    'R_sun': 6.957e10, 'Rsun': 6.957e10,
    'M_sun': 1.988409870698051e33, 'Msun': 1.988409870698051e33,
    'R_earth': 6.3781e8, 'Rearth': 6.3781e8,
    'M_earth': 5.972167867791379e27, 'Mearth': 5.972167867791379e27,
}


class _Unit:
    """A unit = pure scale factor to CGS.  (No dimension checking — the
    reference only ever converts between commensurable units.)"""

    __slots__ = ('factor', 'name')
    __array_priority__ = 10000  # ndarray * Unit dispatches to __rmul__

    def __init__(self, factor, name=''):
        self.factor = float(factor)
        self.name = name

    # unit algebra
    def __mul__(self, other):
        if isinstance(other, _Unit):
            return _Unit(self.factor * other.factor,
                         f'{self.name}*{other.name}')
        return _Quantity(other, self)

    def __rmul__(self, other):
        return _Quantity(other, self)

    def __truediv__(self, other):
        if isinstance(other, _Unit):
            return _Unit(self.factor / other.factor,
                         f'{self.name}/{other.name}')
        return NotImplemented

    def __rtruediv__(self, other):
        if isinstance(other, _Unit):
            return _Unit(other.factor / self.factor)
        return _Quantity(other, _Unit(1.0 / self.factor))

    def __pow__(self, n):
        return _Unit(self.factor ** n, f'{self.name}**{n}')

    def to(self, other):
        return self.factor / other.factor

    def __repr__(self):
        return f'Unit({self.name or self.factor})'


class _Quantity:
    """value + unit; internal storage is value in the *given* unit."""

    __slots__ = ('_value', 'unit')
    __array_priority__ = 10000

    def __init__(self, value, unit):
        self._value = np.asarray(value, dtype=np.float64)
        self.unit = unit if isinstance(unit, _Unit) else _Unit(unit)

    @property
    def value(self):
        v = self._value
        return float(v) if v.ndim == 0 else v

    @property
    def cgs(self):
        return _Quantity(self._value * self.unit.factor, _Unit(1.0, 'cgs'))

    def to(self, unit, equivalencies=None):
        if isinstance(unit, str):
            unit = Unit(unit)
        return _Quantity(self._value * self.unit.factor / unit.factor, unit)

    def _cgs_val(self):
        return self._value * self.unit.factor

    def __mul__(self, other):
        if isinstance(other, _Quantity):
            return _Quantity(self._cgs_val() * other._cgs_val(),
                             _Unit(1.0, 'cgs'))
        if isinstance(other, _Unit):
            return _Quantity(self._value, self.unit * other)
        return _Quantity(self._value * other, self.unit)

    __rmul__ = __mul__

    def __truediv__(self, other):
        if isinstance(other, _Quantity):
            return _Quantity(self._cgs_val() / other._cgs_val(),
                             _Unit(1.0, 'cgs'))
        return _Quantity(self._value / other, self.unit)

    def __pow__(self, n):
        return _Quantity(self._cgs_val() ** n, _Unit(1.0, 'cgs'))

    def __add__(self, other):
        if isinstance(other, _Quantity):
            return _Quantity(self._cgs_val() + other._cgs_val(),
                             _Unit(1.0, 'cgs'))
        return _Quantity(self._value + other, self.unit)

    def __sub__(self, other):
        if isinstance(other, _Quantity):
            return _Quantity(self._cgs_val() - other._cgs_val(),
                             _Unit(1.0, 'cgs'))
        return _Quantity(self._value - other, self.unit)

    def __getitem__(self, idx):
        return _Quantity(self._value[idx], self.unit)

    def __len__(self):
        return len(self._value)

    def __repr__(self):
        return f'Quantity({self._value!r}, {self.unit!r})'


def Unit(expr):
    """Parse the unit-string forms the reference actually uses:
    'm/(s**2)', 'cm', 'um', 'bar', 'au', 'R_jup', 'erg*cm^(-3)*s^(-1)', …"""
    if isinstance(expr, _Unit):
        return expr
    s = str(expr).replace('^', '**').strip()
    ns = {k: _Unit(v, k) for k, v in _UNIT_ATOMS.items()}
    try:
        out = eval(s, {'__builtins__': {}}, ns)  # noqa: S307 — fixed atoms
    except Exception as e:
        raise ValueError(f'refshim cannot parse unit {expr!r}: {e}')
    if isinstance(out, (int, float)):
        out = _Unit(out, s)
    out.name = s
    return out


class _Constant(_Quantity):
    """astropy constant: .value is the SI value (astropy default);
    .cgs / .to() convert correctly."""

    __slots__ = ('si_value',)

    def __init__(self, si_value, cgs_factor):
        # store in a pseudo-unit whose factor converts SI-number -> CGS
        super().__init__(si_value, _Unit(cgs_factor, 'si-base'))
        self.si_value = si_value

    @property
    def value(self):
        return self.si_value


def _make_astropy():
    astropy = types.ModuleType('astropy')

    units = types.ModuleType('astropy.units')
    units.Unit = Unit
    for k, v in _UNIT_ATOMS.items():
        setattr(units, k, _Unit(v, k))
    quantity = types.ModuleType('astropy.units.quantity')
    quantity.Quantity = _Quantity
    units.quantity = quantity
    units.Quantity = _Quantity

    constants = types.ModuleType('astropy.constants')
    # (SI value, factor SI-unit -> CGS-unit)
    constants.G = _Constant(6.6743e-11, 1e3)          # m3/kg/s2 -> cm3/g/s2
    constants.k_B = _Constant(1.380649e-23, 1e7)      # J/K -> erg/K
    constants.u = _Constant(1.66053906892e-27, 1e3)   # kg -> g
    constants.R = _Constant(8.31446261815324, 1e7)    # J/mol/K -> erg/mol/K
    constants.h = _Constant(6.62607015e-34, 1e7)      # J s -> erg s
    constants.c = _Constant(2.99792458e8, 1e2)        # m/s -> cm/s
    constants.sigma_sb = _Constant(5.6703744191844294e-8, 1e3)
    constants.L_sun = _Constant(3.828e26, 1e7)
    constants.M_jup = _Constant(1.8981245973360505e27, 1e3)
    constants.R_jup = _Constant(7.1492e7, 1e2)
    constants.M_sun = _Constant(1.988409870698051e30, 1e3)
    constants.R_sun = _Constant(6.957e8, 1e2)
    constants.au = _Constant(1.49597870700e11, 1e2)

    io_mod = types.ModuleType('astropy.io')
    fits = types.ModuleType('astropy.io.fits')

    def _fits_unavailable(*a, **k):
        raise RuntimeError('refshim: astropy.io.fits is stubbed '
                           '(not needed on the parity call path)')

    fits.open = _fits_unavailable
    fits.getdata = _fits_unavailable
    io_mod.fits = fits

    utils = types.ModuleType('astropy.utils')
    misc = types.ModuleType('astropy.utils.misc')

    class JsonCustomEncoder(json.JSONEncoder):
        def default(self, obj):
            if isinstance(obj, (np.ndarray, np.number)):
                return obj.tolist()
            if isinstance(obj, (complex, np.complexfloating)):
                return [obj.real, obj.imag]
            if isinstance(obj, bytes):
                return obj.decode()
            return json.JSONEncoder.default(self, obj)

    misc.JsonCustomEncoder = JsonCustomEncoder
    utils.misc = misc

    convolution = types.ModuleType('astropy.convolution')

    def _conv_unavailable(*a, **k):
        raise RuntimeError('refshim: astropy.convolution is stubbed')

    convolution.convolve = _conv_unavailable
    convolution.Box1DKernel = _conv_unavailable
    convolution.Gaussian1DKernel = _conv_unavailable

    astropy.units = units
    astropy.constants = constants
    astropy.io = io_mod
    astropy.utils = utils
    astropy.convolution = convolution
    return {
        'astropy': astropy,
        'astropy.units': units,
        'astropy.units.quantity': quantity,
        'astropy.constants': constants,
        'astropy.io': io_mod,
        'astropy.io.fits': fits,
        'astropy.utils': utils,
        'astropy.utils.misc': misc,
        'astropy.convolution': convolution,
    }


# ---------------------------------------------------------------------------
# synphot / stsynphot (file-star path only)
# ---------------------------------------------------------------------------

def _make_synphot():
    synphot = types.ModuleType('synphot')
    models = types.ModuleType('synphot.models')

    class Empirical1D:
        pass

    class SourceSpectrum:
        """File-star path of justdoit.star(): stores (points, lookup_table)
        quantities; waveset ascending in wavelength; __call__ returns the
        flux converted to the requested unit."""

        def __init__(self, model, points=None, lookup_table=None, **kw):
            order = np.argsort(points._value)
            self._points = _Quantity(points._value[order], points.unit)
            self._flux = _Quantity(lookup_table._value[order],
                                   lookup_table.unit)

        @property
        def waveset(self):
            return self._points

        def __call__(self, waveset, flux_unit=None, **kw):
            if flux_unit is None:
                return self._flux
            return self._flux.to(flux_unit)

    models.Empirical1D = Empirical1D
    synphot.SourceSpectrum = SourceSpectrum
    synphot.models = models

    stsynphot = types.ModuleType('stsynphot')

    def grid_to_spec(*a, **k):
        raise RuntimeError('refshim: stsynphot grids unavailable — use '
                           'star(filename=..., w_unit=..., f_unit=...)')

    stsynphot.grid_to_spec = grid_to_spec
    return {'synphot': synphot, 'synphot.models': models,
            'stsynphot': stsynphot}


# ---------------------------------------------------------------------------
# generic raising stubs: virga, bokeh, xarray, pooch
# ---------------------------------------------------------------------------

class _Stub:
    def __init__(self, name):
        self._name = name

    def __call__(self, *a, **k):
        raise RuntimeError(f'refshim: {self._name} is stubbed '
                           '(outside the parity call path)')

    def __getattr__(self, attr):
        if attr.startswith('__'):
            raise AttributeError(attr)
        return _Stub(f'{self._name}.{attr}')

    def __iter__(self):
        return iter(())

    def __getitem__(self, item):
        return _Stub(f'{self._name}[{item!r}]')


def _stub_module(name, **attrs):
    mod = types.ModuleType(name)
    for k, v in attrs.items():
        setattr(mod, k, v)
    mod.__getattr__ = lambda attr: _Stub(f'{name}.{attr}')
    return mod


def _make_misc():
    mods = {}
    virga = _stub_module('virga')
    virga_jdi = _stub_module('virga.justdoit')
    virga.justdoit = virga_jdi
    mods['virga'] = virga
    mods['virga.justdoit'] = virga_jdi

    for sub in ['', '.plotting', '.palettes', '.models', '.layouts', '.io']:
        name = 'bokeh' + sub
        mods[name] = _stub_module(name)
    # palettes referenced as values at import time
    mods['bokeh.palettes'].Colorblind8 = ['#000000'] * 8
    mods['bokeh.palettes'].Cividis = {n: ['#000000'] * n
                                      for n in range(3, 12)}
    mods['bokeh.palettes'].inferno = lambda n: ['#000000'] * n
    mods['bokeh'].palettes = mods['bokeh.palettes']
    mods['bokeh'].plotting = mods['bokeh.plotting']

    xr = _stub_module('xarray')
    core = _stub_module('xarray.core')
    dataset = _stub_module('xarray.core.dataset')

    class Dataset:  # only used in isinstance() checks on 3D paths
        pass

    dataset.Dataset = Dataset
    core.dataset = dataset
    xr.core = core
    xr.Dataset = Dataset
    mods['xarray'] = xr
    mods['xarray.core'] = core
    mods['xarray.core.dataset'] = dataset

    mods['pooch'] = _stub_module('pooch')
    return mods


# ---------------------------------------------------------------------------
# loader
# ---------------------------------------------------------------------------

def install_shims():
    # modern sqlite3 binds unknown types (np.int64/np.float64 query params,
    # as the reference's _get_query_molecular passes) as silently-unmatching
    # BLOBs; older pythons coerced them.  Restore the reference's intended
    # behavior with explicit scalar adapters.
    import sqlite3
    for t in (np.int8, np.int16, np.int32, np.int64,
              np.uint8, np.uint16, np.uint32, np.uint64):
        sqlite3.register_adapter(t, int)
    for t in (np.float16, np.float32, np.float64):
        sqlite3.register_adapter(t, float)

    shims = {}
    shims.update(_make_numba())
    shims.update(_make_astropy())
    shims.update(_make_synphot())
    shims.update(_make_misc())
    for name, mod in shims.items():
        if name not in sys.modules:
            sys.modules[name] = mod


def load_reference(module='justdoit'):
    """Import and return a reference picaso module (pure-numpy via shims).

    The reference reads ``picaso_refdata`` at import time, so the env var is
    pointed at the reference's own refdata tree for the duration of the
    import (and left there — the reference caches it as a module global,
    while picaso_tpu resolves its refdata per call from its bundled tree).
    """
    key = f'picaso.{module}'
    if key in _loaded:
        return _loaded[key]
    install_shims()
    # the reference reads picaso_refdata both at import (module globals)
    # and at runtime (e.g. raman_pollack, optics.py:645), so the env var
    # stays pointed at the reference tree.  picaso_tpu is expected to work
    # against the reference-layout refdata too (external_refdata with
    # bundled fallback), so sharing the env var is fine — and covered by
    # the rest of the suite running after these tests.
    os.environ['picaso_refdata'] = REFERENCE_REFDATA
    os.environ.setdefault(
        'PYSYN_CDBS', os.path.join(REFERENCE_REFDATA, 'stellar_grids'))
    if REFERENCE_ROOT not in sys.path:
        sys.path.insert(0, REFERENCE_ROOT)
    import importlib
    mod = importlib.import_module(key)
    _loaded[key] = mod
    return mod
