"""Tracing, profiling, and structured run logs.

The reference has no profiling story — diagnostics are ``verbose=True``
prints and the climate iterate capture (``climate.py:3070``,
``io_utils.write_all_profiles``).  SURVEY §5 calls for real device-side
observability, which this module provides:

- :func:`trace` — context manager around ``jax.profiler`` emitting an
  xprof/TensorBoard trace directory (device + host timelines, HLO).
- :func:`device_timer` / :class:`Timer` — wall timers that
  ``block_until_ready`` on device outputs, so numbers mean "device work
  finished", not "dispatch enqueued" (JAX dispatch is asynchronous,
  so un-synced timings measure the enqueue).
- :func:`cost_analysis` — XLA's flop / bytes-accessed / transcendental
  counts for a jitted function, the first stop for roofline reasoning.
- :class:`RunLog` — append-only JSONL structured logs (climate
  iterations, sampler progress) replacing the reference's prints.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import jax
import numpy as np

__all__ = ['trace', 'Timer', 'device_timer', 'cost_analysis', 'RunLog']


@contextlib.contextmanager
def trace(logdir='/tmp/picaso_tpu_trace', host=True):
    """Capture an xprof trace of the enclosed block.

    View with TensorBoard's profile plugin or ``xprof``.  ``host=False``
    skips host-side Python tracing (smaller dumps).
    """
    os.makedirs(logdir, exist_ok=True)
    jax.profiler.start_trace(logdir, create_perfetto_link=False,
                             create_perfetto_trace=not host)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


class Timer:
    """Accumulating device-synced timer.

    >>> t = Timer()
    >>> with t('forward'):
    ...     out = forward(...)          # block happens on __exit__
    >>> t.times['forward']
    """

    def __init__(self):
        self.times = {}
        self.counts = {}
        self._pending = None

    @contextlib.contextmanager
    def __call__(self, name):
        start = time.perf_counter()
        holder = []
        try:
            yield holder
        finally:
            if holder:
                jax.block_until_ready(holder)
            elapsed = time.perf_counter() - start
            self.times[name] = self.times.get(name, 0.0) + elapsed
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self):
        return {k: {'total_s': v, 'calls': self.counts[k],
                    'mean_s': v / self.counts[k]}
                for k, v in self.times.items()}


def device_timer(fn, *args, iters=5, warmup=1, perturb=None, **kwargs):
    """Steady-state seconds/call of ``fn`` with device synchronization.

    ``perturb``: optional callable ``i -> replacement first arg`` so each
    iteration dispatches distinct work.
    """
    for _ in range(warmup):
        jax.block_until_ready(fn(*args, **kwargs))
    start = time.perf_counter()
    out = None
    for i in range(iters):
        a = (perturb(i),) + args[1:] if perturb is not None else args
        out = fn(*a, **kwargs)
    jax.block_until_ready(out)
    return (time.perf_counter() - start) / iters


def cost_analysis(fn, *args, **kwargs):
    """XLA cost analysis of the compiled ``fn(*args)``.

    Returns {'flops', 'bytes_accessed', 'transcendentals', ...} summed
    over the entry computation — the roofline inputs (HBM bandwidth is
    the usual accelerator bottleneck, SURVEY §7).
    """
    lowered = jax.jit(fn).lower(*args, **kwargs)
    compiled = lowered.compile()
    cost = compiled.cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0]
    return dict(cost)


class RunLog:
    """Structured JSONL run log (one JSON object per line).

    Used by the climate driver for per-iteration records (temperature
    profile hash, max |dT|, zone boundaries, flux residuals) — the
    queryable analog of the reference's ``verbose`` prints +
    ``all_profiles`` arrays.
    """

    def __init__(self, path=None):
        self.path = path
        self.records = []

    def log(self, event, **fields):
        rec = {'event': event, 't': time.time()}
        for k, v in fields.items():
            if isinstance(v, (np.ndarray, jax.Array)):
                v = np.asarray(v)
                rec[k] = (float(v) if v.ndim == 0
                          else v.tolist() if v.size <= 16
                          else {'shape': list(v.shape),
                                'min': float(v.min()),
                                'max': float(v.max()),
                                'mean': float(v.mean())})
            else:
                rec[k] = v
        self.records.append(rec)
        if self.path:
            with open(self.path, 'a') as f:
                f.write(json.dumps(rec) + '\n')
        return rec

    def __iter__(self):
        return iter(self.records)
