"""chip_smoke.py off the card, and what the package does at import.

The smoke test proves the system on a GPU; here it must refuse to run
(no GPU, or no package beside it) and its tolerance helpers must judge
correctly.  Importing the package sets the persistent compile cache and
keeps the compiled core free of the user API's dependencies.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402


def _run(args, cwd, env_update=None, timeout=300):
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    for k, v in (env_update or {}).items():
        if v is None:
            env.pop(k, None)
        else:
            env[k] = v
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize('alone', [False, True])
def test_smoke_refuses_without_gpu(tmp_path, alone):
    """No GPU backend, or chip_smoke.py with nothing of the repo beside
    it: non-zero exit and no result line."""
    if alone:
        shutil.copy(os.path.join(ROOT, 'chip_smoke.py'), tmp_path)
        cwd = str(tmp_path)
    else:
        cwd = ROOT
    res = _run(['chip_smoke.py'], cwd)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    for line in res.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


@pytest.mark.parametrize('a,b,floor,want', [
    ([1.0, 2.0], [1.0, 2.0], 0.0, (0.0, 0.0)),
    ([1.01, 2.0, 3.0], [1.0, 2.0, 3.0], 0.0, (1e-2, 0.0)),
    ([1e-9, 1.0], [0.0, 1.0], 1e-6, (1e-3, 5e-4)),
])
def test_rel_err(a, b, floor, want):
    got = chip_smoke.rel_err(a, b, floor=floor)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-15)


@pytest.mark.parametrize('a,b,want', [([1.0, 2.0], [1.0, 2.0], 0.0),
                                      ([1.0, 2.1], [1.0, 2.0], 0.05),
                                      ([1e-9, 4.0], [0.0, 4.0], 2.5e-10)])
def test_peak_err(a, b, want):
    assert chip_smoke.peak_err(a, b) == pytest.approx(want, rel=1e-9,
                                                      abs=1e-15)


@pytest.mark.parametrize('a,b', [([np.nan, 1.0], [1.0, 1.0]),
                                 ([1.0, 1.0], [1.0, 1.0, 1.0])])
def test_rel_err_rejects_bad_results(a, b):
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.rel_err(a, b)


@pytest.mark.parametrize('value,limit,passes', [(1e-5, 1e-4, True),
                                                (1e-4, 1e-4, True),
                                                (2e-4, 1e-4, False),
                                                (np.nan, 1e-4, False)])
def test_check(value, limit, passes):
    if passes:
        chip_smoke.check('x', value, limit)
    else:
        with pytest.raises(chip_smoke.SmokeFailure):
            chip_smoke.check('x', value, limit)


@pytest.mark.parametrize('env_dir', [None, 'given'])
def test_compile_cache_dir(tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins untouched; otherwise <repo>/.jax_cache."""
    env = {'JAX_COMPILATION_CACHE_DIR':
           str(tmp_path / env_dir) if env_dir else None}
    res = _run(['-c', 'import picaso_tpu, jax; '
                'print(jax.config.jax_compilation_cache_dir)'], ROOT, env)
    assert res.returncode == 0, res.stderr
    want = (str(tmp_path / env_dir) if env_dir
            else os.path.join(ROOT, '.jax_cache'))
    assert res.stdout.strip().splitlines()[-1] == want


def test_compiled_core_imports_without_user_api():
    res = _run(['-c', 'import sys, picaso_tpu.pipeline, picaso_tpu.parallel, '
                'picaso_tpu.rt.toon_kernel; '
                'print(sorted(m for m in ("pandas", "h5py", "matplotlib") '
                'if m in sys.modules))'], ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == '[]'
