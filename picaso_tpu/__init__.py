"""picaso_tpu: exoplanet and brown-dwarf spectroscopy, climate and
retrieval in JAX.

A ground-up reimplementation of the capabilities of PICASO
(natashabatalha/picaso) around compiled device programs: opacity grids
resident in device memory, radiative-transfer kernels vectorized over the
wavelength axis, jit-compiled climate iteration, and device-mesh
parallelism for phase curves, model grids and retrievals.  It runs on an
NVIDIA GPU (the Toon89 spectrum solve has a fused kernel there) and on
the host CPU, which the tests use.

Subsystem map (see README.md):
justdoit (user API) / pipeline (fused forward) / rt (kernels) /
opacities (ingestion + interpolation + factory) / climate (RCE solver) /
chemistry / virga (clouds) / analyze + sampler + retrieval + driver
(fitting) / parallel (mesh sharding) / justplotit / io_utils / references /
data.
"""

__version__ = '0.2.0'

import os as _os


def _enable_compilation_cache():
    """Persistent XLA compilation cache, on by default.

    A fresh process then skips the compile of the large fused programs
    (the production forward, the climate Newton solve).  Where
    ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it and nothing is set
    here; otherwise the cache lives in ``.jax_cache`` at the root of the
    checkout, a fixed path, so that later processes find it.
    """
    if _os.environ.get('JAX_COMPILATION_CACHE_DIR'):
        return
    import jax

    jax.config.update('jax_compilation_cache_dir', _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        '.jax_cache'))
    jax.config.update('jax_persistent_cache_min_compile_time_secs', 1.0)


_enable_compilation_cache()

from . import constants, units  # noqa: E402
from .disco import make_geometry  # noqa: E402

_LAZY = {'inputs', 'opannection', 'picaso'}


def __getattr__(name):
    # the user API needs pandas; importing it lazily keeps the compiled
    # core (pipeline, rt, opacities) on jax, numpy and scipy alone
    if name in _LAZY:
        from . import justdoit
        return getattr(justdoit, name)
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')


__all__ = ['inputs', 'opannection', 'picaso', 'make_geometry', 'constants',
           'units', '__version__']
