"""Test configuration: CPU backend with 8 virtual devices + float64.

Numerical-parity tests run in float64 on the host CPU backend (the reference
numba kernels are float64); sharding tests use the 8 virtual CPU devices.
GPU kernels run here in Pallas interpret mode; their compiled form runs on
the card (tests marked ``gpu``, and ``python chip_smoke.py``).

jax may already be imported when this file runs, so the platform is set
through jax.config as well as the environment.
"""

import os

os.environ['JAX_PLATFORMS'] = 'cpu'  # for any subprocesses tests spawn
flags = os.environ.get('XLA_FLAGS', '')
if 'xla_force_host_platform_device_count' not in flags:
    os.environ['XLA_FLAGS'] = (
        flags + ' --xla_force_host_platform_device_count=8').strip()

import jax  # noqa: E402

jax.config.update('jax_platforms', 'cpu')
jax.config.update('jax_enable_x64', True)
